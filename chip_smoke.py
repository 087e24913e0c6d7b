#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``cpt_tpu_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py [--json details.json]

Phases (any failure raises and the script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build the hand-written kernels from ``cpt_tpu_torch/csrc`` (nvcc), and
   check that the shared GEMM's kernels issue wgmma and TMA loads (and the
   row-LayerNorm kernel its cluster barrier) in their SASS (cuobjdump);
3. hold each kernel (K1 grouped conv, K2 RoIAlign, K3 attention block and
   its attention core alone, K4 FFN block at 960, 1920 and 1264 rows, the
   GEMM under both alone beside ``torch.addmm``, K6 flash attention,
   K6b/K6c its backward; K3, K4 and the GEMM by device time too, with the
   GEMM's named faults ``GEMM_FAULTS``; K2 with ``K2_FAULTS``) in bf16
   against its plain PyTorch version in f32 on the same
   inputs, and K5 (greedy NMS) against its plain version exactly on the
   same f32 inputs (``NMS_SHAPES``: the RPN's, the box head's and the
   per-class filters' shapes, with ``NMS_FAULTS`` that must change the
   result), at the main paths' shapes; time each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call (a yardstick the port never calls) with CUDA events (K3's core, K6,
   K6b, K6c and their SDPA yardsticks also by device time under
   ``torch.profiler``, with named faults of an unmasked ragged edge and an
   unrescaled running accumulator, and for the backward a dropped di, an
   unscaled ds, p not divided by l, the bias after the scale and the bias
   read transposed), and compute
   each one's bound (the least time for its bytes and operations at the
   card's published peaks); K1 at its seven X152 shapes on the path its
   dispatch rule names (the tensor-core kernel), with named faults (a
   neighbouring group's inputs, transposed taps, a dropped bias, at stride
   2 a shifted grid), and once at a shape only its CUDA-core kernel takes;
4. at full width (VinVL X152-C4 + Oscar-base, random weights from a seed in
   the reference layouts) answer 3 grounding requests through
   ``cpt_predict.predict`` with given candidates, then one ``--detect``
   request (``DETECT_REQUESTS``, cold) whose candidates the detector
   proposes, then the 3 grounding
   requests again with an Oscar-base built with ``attention_impl="flash"``
   beside the same detector (same boxes, scores within SCORE_TOL of the
   "auto" path's and of the f32 path's, two named faults missing it, K6 12
   launches a scoring batch, K3 none), then one long-context
   ``BertImgModel`` forward under ``"flash"`` and one under ``"auto"``
   (batch 4, 70 text tokens + 950 regions; K6, then K3, 12 launches) against
   the einsum path in f32; check that every kernel of each
   path ran on it, K1 on the path its rule names; profile one 16-candidate
   grounding request and one detect step with ``torch.profiler``;
5. few-shot prompt tuning at full width: extract stage-1 features of 16
   grounding queries with the resident detector, then train Oscar-base
   under ``attention_impl="flash"`` (attention dropout 0, hidden dropout
   0.1) through ``refcoco_cpt.train`` for ``TRAIN_STEPS`` (10) steps of
   batch 32 (K6, K6b and
   K6c 12 launches a step, K3 and K4 none); hold one step's gradients and a
   10-step loss curve (dropout off) against the f32 einsum path; then 3
   deterministic steps under ``"auto"`` (K3 and K4 12 a step, their
   backward the plain VJP);
6. W8A8 int8: K1q (the int8 grouped conv) at K1's seven X152 shapes on
   the path its rule names (the int8 tensor-core kernel) and at
   ``K1_SIMT_SHAPE`` (its ``__dp4a`` kernel), bit for bit against its plain
   version in bf16 and within TOL of it in f32, with named faults that must
   miss (``K1Q_FAULTS`` among them), by device time beside K1; K7 (the
   fused W8A8 FFN of ``bench_int8.py``'s study, M 16384, tm 1024) against
   its plain version with ``K7_FAULTS``, by device time (all of its
   launches) beside K4 and bench_int8's ``xla_int8`` composition (two
   ``torch._int_mm`` calls) as its yardstick, and its cosine against K4;
   then ``tools/extract_features --synthetic 4 --precision int8`` (and
   ``int8:<s>``) at full width (K1q 50 launches a chunk, all on the path
   its rule names, K1 none), its features against the same run with the
   int8 ops swapped for their plain versions, and its copies/s and
   features against ``--precision bf16``;
7. the windowed path (``engine/windowed.py``) on phase 4's weights: K1 at
   the shapes only it gives K1 (``K1_WINDOW_SHAPES``: layer1 and layer2
   on each rung's window; ``K1_CASCADE_SHAPES``: the cascade's odd layer3
   windows) against its plain version and its named faults, by device
   time; a 16-candidate request through ``cpt_predict.predict`` on a
   ``cpt_predict.Resident(windowed=True)``, two-level (every rung of the
   ladder and the full path take copies; K1 11 launches for the base pass
   and 50 a chunk, all on the tensor-core path), against the same request
   on the full path: features within WINDOW_TOL, labels equal, scores
   within SCORE_TOL, and each of WINDOW_FAULTS missing WINDOW_TOL; both
   by host time and under ``torch.profiler``; ``extract_features
   --synthetic 8 --windowed --copies_per_chunk 8`` with the base passes
   batched by 8 and one a query against the full path (each warmed up,
   then timed once); and one cascaded
   two-level call against the plain one;
8. the Pillow-free pixel operations (``utils/image_ops``) on the host:
   ``RESIZE_DIGESTS`` (Pillow 12.1's output on seeded inputs) reproduced,
   each of ``IMAGE_OP_FAULTS`` changing one, host ms per call; then the
   grounding server (``tools/serve.py``, built through its own
   ``build_args`` / ``CPTService`` at full width, random weights from seed
   0): an 8- and a 16-candidate request on 600×800 arrays (no resize)
   against ``cpt_predict.predict`` on the same weights (same box, scores
   within SCORE_TOL; K1 50 and K2 1 a request, K3 and K4 12 a scoring
   batch), two 8-candidate requests that take the resize rule
   (``RESIZED_REQUESTS``: 480×640 ×1.25 and 1200×1600 ×0.5, to 600×800)
   against ``cpt_predict.predict`` on the image resized by image_ops and
   the dets scaled (the same pick, scores within SCORE_TOL, K1 50, K2 1,
   K3 12, K4 12 each; host ms, and host and device ms under
   ``torch.profiler`` beside an 8-candidate 600×800 request's), HTTP on 127.0.0.1 (``/healthz`` reports "cuda", 129 dets → 400,
   an unknown path → 404, a predict round trip with a JPEG upload, held to
   ``CPTService.predict`` on the decoded array; during it every output of
   both models an inference tensor and no parameter with a gradient;
   allocated bytes within 1% after 1 and 10 requests; the two resized
   requests as quality-95 JPEG uploads too, each decoded as Pillow decodes
   it (``CODEC_DIGESTS``), answered exactly as the direct call on the
   decoded image, K1 50, K2 1, K3 12, K4 12, held to ``cpt_predict`` on
   the decoded image as the raw-array requests are, and its scores and
   ``cpt_predict``'s each within SCORE_TOL of the f32 einsum path; one
   lossy-with-alpha WEBP upload, ``WEBP_UPLOAD``, and one YCbCr-JPEG TIFF
   upload, ``TIFF_UPLOAD``, each decoded as Pillow decodes it and answered
   exactly as the direct call on the decoded image, K1 50, K2 1, K3 12, K4
   12), K3 at
   its smallest bucket ``[8,78,768]`` with the ragged-edge fault, host ms
   per request and one request's profile; then ``--windowed --base_batch
   4``: 4 queued requests drain as one batched base pass and answer as the
   same 4 served one at a time;
9. VCR: K3 (block and streamed core) at ``[32,140,768]``, K4 at 4480 rows,
   K6 / K6b / K6c at ``[16,12,140,64]`` against their plain versions and
   named faults; 4 questions painted from numpy masks in 3 colors
   (``stage1_tasks.vcr_color_task_from_masks``, two members on one box)
   and extracted by phase 4's detector (K1 50 and K2 1 a question);
   ``extract_features --task vcr`` over ``vcr_polygon_fixture`` (2
   questions on multi-part polygons with an empty and a one-point part, a
   member without a polygon), its TSV byte-equal to the same run fed
   ``image_ops.fill_polygon``'s masks through ``vcr_color_task_from_masks``
   (K1 50 and K2 1 a question); q->a,
   qa->r and q->ar (twin heads, the "rat" head moved off the "ans" one)
   scored by ``vcr_nsp_cpt.run_eval`` under ``"auto"`` (K3 and K4 12 a
   batch), each candidate within VCR_SCORE_TOL of an f32 einsum NSPCPT
   carrying the head it should use, with ``VCR_FAULTS`` (and, for the twin,
   the other head) missing it; TUNING_STEPS prompt-tuning
   steps of ``vcr_nsp_cpt.train`` under ``"flash"`` (K6, K6b, K6c 12 a
   step; K3 and K4 none); one step's NSP gradients on a synthetic
   VCR-shaped batch within GRAD_TOL of f32 einsum per q / k / v block,
   with K6b's dK zeroed missing it;
10. the other CPT tasks: K3 (block and core) at GQA's eval batch
   ``[128,90,768]`` and VG's ``[48,120,768]``, K4 at 11,520 and 5,760
   rows, K6 / K6b / K6c at ``[16,12,90,64]`` and ``[24,12,120,64]``
   against their plain versions and named faults. GQA: 8 questions on one
   600×800 image, parsed to marks (``stage1_tasks.parse_gqa_marks``),
   painted inclusively (``gqa_mark_task``) and extracted with a labelmap
   (K1 50 and K2 1 a chunk; their plain features too), the features
   bit-equal to the same copies painted ``[x1, x2]`` on the host (painted
   ``[x1, x2)`` miss), scored by ``gqa_cpt.evaluate`` at batch 128 (K3 and
   K4 12) within GQA_SCORE_TOL (mean) and GQA_SCORE_MAX_TOL (largest) of
   an f32 einsum REC_MLM_CPT, with GQA_FAULTS missing the first and
   GQA_ROW_FAULTS the second, then TUNING_STEPS optimizer steps of
   ``gqa_cpt.train`` under ``"flash"`` (32
   questions drawn with replacement, batch 16, so 2 calls a step; K6, K6b,
   K6c 12 a call). VG: every overlapping pair of 8 boxes (16) painted
   subject red, object blue (``vg_pair_task``; K1 50, K2 1), the features
   bit-equal to the same copies painted on the host (the colors swapped
   miss), scored by ``vg_cpt.evaluate`` (2 batches of 48 sequences, three
   masks each) within VG_LOGPROB_TOL (mean) and VG_LOGPROB_MAX_TOL
   (largest) of f32, with VG_FAULTS missing the first and VG_ROW_FAULTS
   the second, recall on a synthetic ground truth, 10 steps of ``vg_cpt.train`` under
   ``"flash"``. SEG: one 8-candidate RefCOCO request whose candidates
   carry elliptic masks (RLE round trip) on the full path and two-level
   windowed (every rung and the full path take copies; K1 11 + 50 a
   chunk): the same box and bit-equal features, which the boxes painted
   in the masks' place move beyond WINDOW_TOL.
11. the full-finetune baselines on fresh heads over random Oscar-base
   encoders: K3 (block and core) at REC_FT's eval batch ``[64,120,768]``,
   K4 at 7,680 rows and K6b / K6c at its training batch ``[16,12,120,64]``
   against their plain versions and named faults. REC_FT through
   ``refcoco_ft.main`` on phase 5's 16 stage-1 queries: TUNING_STEPS steps
   of batch 16 under ``"flash"`` (attention dropout 0, hidden dropout 0.1; K6, K6b,
   K6c 12 a step, K3 and K4 none), eval at batch 64 under ``"auto"`` (K3
   and K4 12), every slot's score within REC_FT_SCORE_TOL of an f32 einsum
   REC_FT on the trained weights, ``REC_FT_FAULTS`` missing it, and one
   step's gradients per q / k / v block within REC_FT_GRAD_TOL of f32 (K6b's
   dK zeroed missing it). GQA FT through ``gqa_cpt.main --model_variant ft``
   (8 questions on plain features, TUNING_STEPS optimizer steps of 2 calls
   under ``"flash"``, eval at ``[128,90]``, logits within GQA_FT_LOGIT_TOL of
   f32, ``GQA_FT_FAULTS`` missing it), then ``--save_dir`` loaded into a
   fresh model whose logits are bit-equal. VCR FT through
   ``vcr_nsp_cpt.main --model_variant ft``: q->a trains TUNING_STEPS steps
   under ``"flash"``, q->a and q->ar (twin classifiers) score within
   VCR_FT_SCORE_TOL of f32, ``VCR_FT_FAULTS`` and the other classifier
   missing it. One forward of VGFT, the sequence classifier (mlp; kl and
   bce) and the multiple-choice model (2 choices, ``use_img_layernorm``)
   within FT_LOGIT_TOL of f32, ``FT_HEAD_FAULTS`` missing it. ``sweep
   --task gqa`` over shots 1 2 × seeds 0 1 (the FT variant at
   SWEEP_LAYERS), and ``fewshot_eval`` over its pickles reports as
   ``seed_sweep_report`` of its accuracies.
12. the detector's entry points at full width (VinVL X152-C4 from the
   reference's own yaml, random weights from seed 0, the 1024×1024
   canvas): ``VINVL_YAML`` with refcoco_val.sh's opts (``REFCOCO_OPTS``)
   resolves through ``load_reference_yaml`` to ``VINVL_X152C4`` field for
   field; ``test_detector.main --config_file --opts DETECTOR_OPTS
   --synthetic 4 --coco_eval`` (VOC mAP and COCO AP / AP50 / AP75 finite,
   each image's detect step launching K1, K2 and K5 at least as often as
   phase 4's detect step, every K1 launch on the path its rule names; host
   ms per image, one step under ``torch.profiler``), once with an
   ``--expected_results`` it meets (ok) and once with one it misses (not
   ok); ``--attr_eval`` over a 4-image VG-TSV written by
   ``write_detection_tsv`` (force-boxes mode: K1 and K2, no K5; attribute
   mAP finite); ``extract_features --image_dir`` over the 4 images as
   ``.jpg`` files (quality 95, through ``utils/image_codec``), each row's
   rects equal to ``test_detector``'s detect step run on that file's
   decoded pixels and its 2054-d features finite; ``extract_features --task refcoco --resize`` over 2 480×640
   images whose 3 dets carry RLE masks (``seg_resize_extract``; image and
   masks rescaled ×1.25 by image_ops): 2 rows of 3 copies, finite
   features, K1 50 and K2 1 an image.
13. the Oscar classification runners at full width, cut to
   ``OSCAR_LAYERS`` (6) of Oscar-base's 12 layers (from one random
   reference-layout checkpoint, seed 0; heads fresh from seed 0,
   their biases drawn from N(0, OSCAR_BIAS_STD²)) on synthetic 2054-d
   region features (``oscar_fixture``): K3 (block and core; the core on
   its streamed branch at S 178, ragged at 50, where an unrescaled running
   sum, ``core_no_rescale``, must miss) at VQA's eval batch
   ``[64,178,768]``, NLVR2's pair batch ``[128,95,768]`` and its concat
   batch ``[64,135,768]`` (streamed, ragged at 7), K4 at 11,392, 12,160
   and 8,640 rows, against their plain versions and named faults.
   ``run_vqa.main`` (kl then bce by ``--adjust_loss``, 2 epochs of 2
   steps, ``--eval_every 1`` on 64 questions, ``checkpoint-{epoch}``, 8
   test questions' submission read back), ``run_gqa.main`` (xe, its
   test-std rows), ``run_nlvr.main`` in pair mode (AdamW) and concat mode
   (Adamax), ``run_retrieval.main`` over 64 caption × image pairs, the
   re-rank of 8 candidates an image and the 3-D CL mask: every training
   step (dropout on: no kernel) and eval call recorded (``Driven``);
   each runner's eval within its ``OSCAR_TOL`` of an f32 einsum model on
   the trained weights (the plain bf16 path's gap read beside it), its
   ``OSCAR_FAULTS`` missing it and farther than ``OSCAR_FAULT_MARGIN`` ×
   the run's own gap; K3 and K4 one a layer a
   64-row eval batch, K3 none under the CL mask; scores and R@K finite;
   host ms per step and per eval batch; a retrieval run cut at step 2
   (``--max_steps``, ``--save_every``) and ``--resume``d, bit-equal to its
   uninterrupted twin (or, should an op prove nondeterministic, no farther
   from it than a second uninterrupted run).
14. Oscar captioning at full width, cut to ``CAPTION_LAYERS`` (3) of
   Oscar-base's 12 layers (an untied decoder, from one random
   reference-layout checkpoint, seed 0; the MLM head fresh from seed 0;
   vocab 30522, S = 70 + 50) on phase 13's fixture (8 captioned
   images of 50 2054-d regions): K4 at the decode's ``[600,768]`` and K6
   at ``[5,12,120,64]`` with five seq2seq biases ``[5,1,120,120]`` against
   their plain versions, and at a greedy step's 120 rows and ``[1,12,120,64]``
   and CBS's 2,400 rows (K6's named faults: the bias read key-only, row 0
   broadcast, and transposed). ``run_captioning.main``: 4 XE steps of batch
   16 (drop-worst from step 2; dropout on: no kernel), ``--eval_every 2``
   on 2 images (greedy), ``SCST_STEPS`` (1) SCST step of 5 rollouts (peak device memory
   read), beam 5 keeping 2 over the 8 images; the XE run cut at step 2 and
   ``--resume``d, its step-4 train state bit-equal to the first run's,
   with a greedy decode; on the first run's state, 4 images and
   ``--max_gen_length 20``, sampling (top-k 20, 2 draws an image) under
   ``"flash"`` and CBS over 2 od labels: every decode launches K4 one a
   layer a step (39 steps; 19 at 20 tokens) and K3 none, under ``"flash"``
   K6 one a layer a step too, an SCST step three decodes' worth; the
   beam decode's best captions' teacher-forced per-step log-probs in bf16
   within CAPTION_TOL of the f32 einsum path, ``CAPTION_FAULTS`` missing
   it; host ms per decode and SCST step, one beam decode's device time by
   kernel family.
15. Oscar+ pretraining, discrete codes and ``explore`` at full width
   (Oscar-base, random reference-layout weights, seed 0):
   ``run_oscarplus_pretrain.main`` on phase 13's fixture (16 images of 50
   2054-d regions, a caption each; batch 16, S 35 + 50): 4 steps at dropout
   0.1 (no kernel), one batch's MLM and contrastive losses in bf16 (eval:
   K3 and K4 12) within PRETRAIN_TOL of the f32 einsum path, with
   ``PRETRAIN_FAULTS`` missing it; the run cut at step 2 and ``--resume``d,
   bit-equal to the uninterrupted one; 2 steps under ``--drop_out 0`` (K4
   12 a step, the backward the plain VJP; K3 none, the attention
   probabilities' dropout keeps it off). ``run_vqa --img_feature_type
   dis_code`` on 16 images of 50 VQ-VAE code ids with a [512, 512]
   codebook (the code table starts from it; the checkpoint has none): 2
   steps, eval (K3 and K4 12), its logits within OSCAR_TOL["vqa"] of f32.
   ``explore`` on a RefCOCO fixture of 8 queries × 4 copies: templates 1
   and 2 (one eval batch each, K3 and K4 12), then the soft prompt (2 + 2
   slots; 3 deterministic steps, K3 and K4 12 a step), the slot rows moved
   and every other row of the table kept bit for bit.
16. detector training at full width (VinVL X152-C4, random weights from
   seed 0, each block's last frozen BN scaled by DET_BRANCH_SCALE and the
   RPN's box deltas by DET_RPN_DELTA_SCALE so that the sums and the
   proposals stay finite; the 1024×1024 canvas, bf16): K1's backward (the kernel forward,
   cuDNN's plain VJP backward) at ``K1_GRAD_SHAPES`` against the f32 plain
   VJP within BWD_GRAD_TOL, the cut gradient (dx = 0, what a wrapper
   writing into a fresh tensor gives) and dw of the neighbouring group
   missing it; K2's dfeats the same way (the cut gradient and the RoIs read
   as (y, x) missing; the RoIs' gradient zero); K5 at the RPN's training
   size, 12,000 → 2,000, exactly; ``train_detector.main --synthetic 1`` for
   DET_STEPS steps: K1 53, K2 2 and K5 1 a step (``DET_STEP_LAUNCHES``),
   finite losses, host ms per step, the peak of allocated memory; one step
   on fixed proposals in bf16 against the f32 plain path (K1, K2, K5 on
   their plain versions): the five losses within DET_LOSS_TOL and the
   gradients of ``DET_GRAD_LEAVES`` within DET_GRAD_TOL, ``DET_FAULTS``
   (K1's dx or K2's dfeats cut) missing it; the step's K1 and K2 backward
   timed beside their bounds; one step's device time by kernel family.
17. scene graphs at full width (VinVL X152-C4 from phase 16's seed-0
   weights, the 1024×1024 canvas, bf16; phase 3 holds K1 at the union
   shapes ``K1_UNION_SHAPES`` and K2 on 240 union boxes,
   ``sg_union_rois``): K1's backward at ``[240,14,14,2048]`` stride 2 as
   in phase 16; on a seeded 2-image VG-TSV with relations (``sg_tsv``,
   ``write_detection_tsv``'s JPEG rows), ``test_detector.main --sg --max_rel_dets 16`` (RelDN, the
   relation head at its init from a seed): the ``sg_<protocol>_<k>``
   recalls finite, each SceneParser image K1 53, K2 2, K5 2
   (``SG_IMAGE_LAUNCHES``: one backbone pass), host ms, one image under
   ``torch.profiler``; one SceneParser forward for each of the five
   algorithms (the same launches) whose ``rel_logits`` on the image's
   detections lie within SG_TOL of an f32 twin's on the plain path, with
   ``SG_FAULTS`` (the union as the intersection, subject and object
   swapped, RelDN's frequency prior dropped, the motif LSTMs' i/f gates
   swapped) missing it; ``train_detector.main --sg`` for SG_STEPS steps
   (K1 53, K2 2 a step, ``SG_STEP_LAUNCHES``; host ms, peak memory), then
   one step's loss and ``SG_GRAD_LEAVES`` gradients against the f32 twin
   (SG_LOSS_TOL, SG_GRAD_TOL; K1's dx cut missing it) and one step under
   ``torch.profiler``; ``test_detector --synthetic 2 --bbox_aug`` (hflip):
   K1 100, K2 2, K5 5 an image, then with ``--bbox_aug_scales 0.75,1.25``
   (4 passes, the rescales by ``utils/image_ops``): K1 200, K2 4, K5 9 an
   image; in both each merge's K5 launch equal to ``nms_padded`` on its
   own inputs, mAP finite, and K5 at the largest merge's K in phase 3's
   manner.
18. the detector library modules at full width (random weights from a
   seed, bf16, one 640×1024 canvas): K1 at the fourth stage's
   ``K1_FPN_SHAPES`` (``[1,40,64,2048]`` stride 2, ``[1,20,32,2048]``) beside
   ``F.conv2d(groups=32)``, K2 on the four pyramid levels (1000 RoIs,
   ``library_rois``, 7², a fixed 2×2 grid; ``K2_FAULTS`` but
   ``fixed_grid``), K5 exactly on the RetinaNet merge
   (``retina_merge_inputs``: 5 × 1000 → 100, class offsets to 82,000), each
   against its plain version with its named faults and by device time;
   then ``ResNetFPN`` at the X152 widths with a fourth stage (3, 8, 36, 3)
   and 256 channels (K1 50), ``multilevel_roi_align`` of 1000 RoIs (K2
   4), the FPN ``MaskHead`` (80 classes) on 100 of them, ``paste_masks``
   onto the canvas and ``engine/cityscapes_eval`` on the pasted masks, the
   ``KeypointHead`` (17), ``RetinaNetHead`` (80 classes, 9 anchors) on P2..P6
   and ``retinanet_select`` (K5 1, equal to ``nms_padded`` on its own
   inputs), ``MsViT`` at the default arch (window 7), ``FBNetTrunk`` at
   ``DEFAULT_ARCH`` and a DCN-v2 ``DFConv2d`` at ``[1,40,64,1024]``: counts
   zeroed just before each path and read just after (``LIB_LAUNCHES``),
   shapes and finite values, host ms.
19. the process runtime: two processes (``RankProcesses``, each under
   ``timeout``; started before phase 10, they draw their random weights
   meanwhile, wait for this phase and go on with phase 20) of ``extract_features
   --synthetic 4 --shard_by_process`` on
   the one card in a gloo group on localhost, at full X152 width
   (K1 and K2 in each), ``allreduce_sum`` and ``sync`` across them, the
   shards merged by ``merge_shards``; the merged TSV equals this process's
   one-process extraction of the same queries byte for byte (keys, boxes,
   features).
20. the device meshes and the pipeline: two ranks of one gloo group on the
   one card (``MESH_WORKER`` → ``mesh_rank``, each under ``timeout``), at
   full width: (a) ``extract_features --synthetic 4 --dp 2`` (each chunk's
   4 copies split 2 and 2; K1 and K2 in each rank), its TSV against phase
   19's one-process TSV (byte for byte, else within WINDOW_TOL with the
   first module whose rows differ named: ``first_divergent_module``); (b)
   ``refcoco_cpt --dp 2`` at Oscar-base, dropout off, 2 prompt-tuning
   steps of batch 8 on ``data/synthetic.generate_refcoco_fixture`` against
   one process's: losses within MESH_LOSS_TOL, the first update's
   gradients within MESH_GRAD_TOL, ``MESH_DP_FAULTS`` (the gradient summed
   over the ranks; each rank on its own share, no all-reduce) missing it;
   (c) pipelined scoring, pp 2 × 2 micro-batches of the grounding batch
   ``[16,120]``, all 12 layers, bit-equal to sequential scoring (K3 and K4
   12 a rank), the stages swapped and the last stage's result not
   broadcast missing it; (d) one sharded detector step (one 1024×1024
   image a rank) against the one-process batched step (DET_LOSS_TOL,
   MESH_DET_GRAD_TOL; ``MESH_DP_FAULTS`` missing it; K1 53, K2 2, K5 1 a
   rank); (e) ``tools/dryrun_multichip``'s ranks at dp 1 × tp 2
   (FSDP placement, two accumulated steps, extraction, pp 2 scoring with
   gradients) on CUDA tensors through gloo. Then K1, K2, K3 and K4 at the
   ranks' new launch shapes (``check_mesh_kernels``).
21. real image files (``utils/image_codec``, the host image codec built
   by the host C++ compiler): the committed fixtures (``tests/data/codec``)
   decoded in RGB and L and seeded arrays encoded at quality 75, 92 and
   95, each digest equal to Pillow 12.1's (``CODEC_DIGESTS``; among them
   one digest a damaged JPEG corpus, ``JPEG_DAMAGE_SOURCES``), each of
   ``CODEC_FAULTS`` changing one over its own format's fixtures
   (``CODEC_FAULT_FILES``), decode and encode host ms beside
   Pillow's (``CODEC_PILLOW_MS``); then, at full width, ``cpt_predict.main
   --image x.jpg --out y.png``, ``--image <WEBP_IMAGE>`` (a 480×640
   lossy WEBP with alpha) ``--out w.png``, ``--image <TIFF_IMAGE>`` (a
   480×640 TIFF of YCbCr JPEG strips, 2×2 subsampled) ``--out t.tif`` and
   ``--image <ARITH_IMAGE>`` (a 480×640 arithmetic-coded progressive JPEG)
   ``--out a.png`` (K1 50, K2 1, K3 12, K4 12 each; the written file read
   back equal to the decoded image with the box drawn; the WEBP's, TIFF's
   and arithmetic JPEG's decodes Pillow's),
   ``convert_dataset coco`` over a directory of JPEGs and ``test_detector
   --tsv`` on its yaml (K1, K2 and K5; VOC and COCO metrics finite),
   ``img_info`` over ``.jpg`` and ``.png`` files (sizes equal to the written
   ones) and its colour probes, ``validate_checkpoints --dryrun
   --device cuda`` (its fixture's JPEG bytes equal to Pillow's, the report
   finite), and ``demo --image ycck_q75.jpg --detect --out det.png`` (the
   detect step's K1, K2 and K5 and no other kernel; the PNG read back equal
   to ``overlay_detections`` of the returned detections under non-ASCII
   class names). The fixtures include CMYK and YCCK JPEG, 16-bit PNG, GIF,
   BMP, WEBP (lossy VP8 with its filters, partitions and segments,
   lossless VP8L, ALPH planes, animations) and TIFF (raw, LZW with and
   without the predictor, PackBits, Deflate and JPEG; strips, tiles and
   planes; both byte orders, BigTIFF; grey, palette, RGB(A) at 8 and 16
   bits, CMYK, YCbCr), and a caption case
   (``caption_case``) drawn by ``utils/text``
   whose digest is the JAX demo's (Pillow's ``ImageDraw.text``).
22. VinVL_L (``--model_size large``: 24 × 1024, 16 heads, FFN 4096; random
   weights from seed 0) and the widths the JAX gates send to their Pallas
   kernels: (b) K3 and K4 at VinVL_L's eval batch ``[64,178,1024]``, K3's
   core at head_dim 24 (the zero-padded tile), 32, 80, 128, 256 and 512 (the
   CUDA-core kernel) beside SDPA, the row-LayerNorm GEMM at N 1024 (the
   cluster), 1280, 2048 and 4096 (the split path) beside ``torch.addmm``, K6 / K6b / K6c at head_dim 80, 256, 40 (padded)
   and 36 (CUDA-core), each against its plain version in f32 with named
   faults (``pad_not_zeroed``, ``tile_stats_dropped``, ``rank0_sums``
   among them), by device time; (a) ``run_vqa.main --model_size large`` (2
   steps, dropout on: no kernel; eval on 64 questions, K3 and K4 24 a
   batch), its logits within ``VINVL_TOL`` of an f32 einsum model on the
   same weights with the bias dropped and K4's LayerNorm per slice missing
   it, one deterministic ``"flash"`` step (K6, K6b, K6c and K4 24 each),
   ``refcoco_cpt.main --model_size large`` scoring one batch of 32
   sequences (K3 and K4 24) within ``VINVL_TOL`` of f32; (c) ``run_vqa``
   eval at ``WIDTH_RUNS`` (hidden 384 over 24 heads, 1280 over 16, 1536 over
   12) within ``VINVL_TOL`` of f32; launches per code path of K3's core,
   the LN GEMM and K6 / K6b / K6c, each path launched.

The last two lines of standard output are a JSON summary of the kernels
and ``{"ok": true, "device": {...}}``. ``chip_e2e.py`` times two commits'
end-to-end paths on one card with this script's functions.
"""
from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import glob
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

# Tolerances of each kernel in bf16 against its plain version in f32 on the
# same bf16 inputs (cuDNN/cuBLAS with TF32 off), as a fraction of the
# reference's largest magnitude. bf16 keeps 8 bits (relative rounding
# 2^-9 ≈ 0.2%); K1/K2 round once (the output), the attention core twice
# (probabilities, context), K3/K4 three to four times.
TOL = {"K1": 1e-2, "K2": 1e-2, "K3": 2e-2, "K3 core": 1e-2, "K4": 2e-2,
       "K6": 1e-2}
# The shared GEMM alone (epilogue (a)): f32 sums, one bf16 rounding.
TOL.update({"K3 gemm": 1e-2, "K4 gemm": 1e-2})
# K6b/K6c: of each gradient's largest magnitude; bf16 rounds p and ds before
# three products, and dq, dk, dv once more
BWD_TOL = 2e-2
# The long-context flash forward (bf16) against the einsum path (f32), as a
# fraction of the reference's largest magnitude: twelve layers of bf16
# rounding (2^-9 each, several per layer).
LONG_TOL = 5e-2
# Candidate scores of the full-width requests, as an absolute limit on each
# of three gaps: the flash path against the "auto" path, and each of them
# against the einsum path in f32 on the same features (the f32 path runs on
# the matrices and tables rounded to bf16, as the bf16 paths compute with
# them: ``rebuilt_scorer``). A score is the reference's ratio of two raw MLM
# logits, logit[color] / logit["none"]; with these weights the logits are
# ~0.5 in size and twelve bf16 layers leave each with an absolute error of
# a few hundredths (0.036-0.042 at full width on the CPU), so a score's
# bf16 error is absolute, not a share of the top score (15% of a top score
# of 0.146 missed a sound run). Sound runs of this script on the H100 80GB
# HBM3 at 700 W read the bf16 paths' gaps to f32 between 1.4e-2 and 2.4e-2
# with the CUDA-core K1, and every gap between 8.6e-3 and 2.481e-2 with the
# tensor-core K1 (a bf16 K1 moves the features the scores are read from);
# with the wgmma GEMM under K3 and K4 every gap lies between 1.175e-2 and
# 3.150e-2 (the flash path against f32 on the first request; the kernels
# are deterministic, so a run reads the same); 4e-2 is 1.27x the largest.
# Two
# named faults of the flash path, its key mask dropped and its 1/sqrt(d)
# scale dropped, must miss it in every run (``SCORE_FAULTS``).
SCORE_TOL = 4e-2
# Phase 5, one step's gradients (flash path in bf16 against the einsum path
# in f32, same weights and batch, dropout off), as the largest per-tensor
# ‖g − g_f32‖ / ‖g_f32‖, on grad_gap's synthetic batch (32 sequences, seed
# 0) and the resident's weights. Derived from the plain path's own
# bf16-vs-f32 gap at full width on the CPU (`python -m
# cpt_tpu_torch.tools.grad_gap --device cpu --batch 32 --seed 0`, and
# `--seed 1`):
# 1.243e-2 and 1.411e-2; the flash path there sits at 1.246e-2 and
# 1.371e-2, the flash path with K6b's dK zeroed at 0.106 and 0.113. 4e-2
# is 2.8x the larger plain gap and 2.6x below the fault's.
GRAD_TOL = 4e-2
# Phase 5, losses of 10 deterministic AdamW steps (lr 2.5e-5, one warmup
# step) on grad_gap's two synthetic batches, flash bf16 against einsum f32,
# in nats. The same CPU run: the losses fall from 10.81 to 3.39 and the
# plain path in bf16 stays within 7.6e-3 of the f32 path at every step
# (the flash path within 8.1e-3). 2.5e-2 is 3.3x the plain gap.
LOSS_TOL = 2.5e-2

# Phase 6. K1q (int8 in, bf16 out) against its plain version in f32 on the
# same int8 inputs: both sum exactly and round the f32 epilogue the same
# way, so only the bf16 store differs (at most 2^-8 of a value). K7 (bf16)
# against its plain version in f32: h and both quantizations agree bit for
# bit, the LayerNorm's sums differ in order and the output rounds once to
# bf16; an h code flipped at a tie moves its row by ~1.6e-3 of scale.
TOL.update({"K1q": 1e-2, "K7": 1e-2})
# The full-width int8 extraction (bf16 activations) against the same run
# with the int8 ops swapped for their plain versions, as max |Δ pooled
# feature| / max |pooled feature|. The two compute the same integers and
# round the same f32 epilogues in the same order, so they must agree bit
# for bit. No looser tolerance would mean anything: rounding every epilogue
# y·m + b once (a fused multiply-add) instead of twice, one ulp, flips
# quantization ties that cascade through the 50 quantized blocks and moves
# the features by 1.4493e-2 of the largest, 60% of what bf16 in place of
# int8 moves them (2.4155e-2): `python -m cpt_tpu_torch.tools.int8_gap` on
# the H100 (4 queries; on the CPU in f32, `--device cpu --synthetic 1`:
# 1.0246e-2 and 1.9619e-2).
INT8_FEATURE_TOL = 0.0
INT8_STATIC_SCALE = 0.05   # the pinned activation scale of the int8:<s> run

# One H100 SXM's published peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores, int8 tensor-core OP/s.
HBM_BYTES_S, BF16_OPS_S, F32_OPS_S = 3.35e12, 989e12, 67e12
INT8_OPS_S = 1979e12

KERNELS = {
    "K1": ("grouped_conv3x3", "cpt_tpu_torch/csrc/grouped_conv.cu",
           "cpt_tpu/ops/grouped_conv.py:418"),
    "K2": ("batched_roi_align", "cpt_tpu_torch/csrc/roi_align.cu",
           "cpt_tpu/ops/roi_align_pallas.py:92"),
    "K3": ("fused_attention_block",
           "cpt_tpu_torch/csrc/gemm.cu cpt_tpu_torch/csrc/attention.cu",
           "cpt_tpu/ops/fused_attention.py:121"),
    "K4": ("fused_ffn", "cpt_tpu_torch/csrc/gemm.cu",
           "cpt_tpu/ops/fused_ffn.py:113"),
    "K5": ("nms_pallas", "cpt_tpu_torch/csrc/nms.cu",
           "cpt_tpu/ops/nms_pallas.py:92"),
    "K6": ("flash_mha", "cpt_tpu_torch/csrc/flash_attention.cu",
           "cpt_tpu/ops/attention.py:70"),
    "K6b": ("flash_mha_bwd_dkv", "cpt_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1121"),
    "K6c": ("flash_mha_bwd_dq", "cpt_tpu_torch/csrc/flash_attention_bwd.cu",
            "jax/experimental/pallas/ops/tpu/flash_attention.py:1456"),
    # no Pallas kernel: the JAX package runs the int8 grouped conv in XLA
    "K1q": ("grouped_conv3x3_int8", "cpt_tpu_torch/csrc/grouped_conv.cu",
            "cpt_tpu/models/detector/resnet.py:176"),
    "K7": ("ffn_int8", "cpt_tpu_torch/csrc/ffn_int8.cu", "bench_int8.py:225"),
}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its peak for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match: str | tuple | None = None, reps: int = 10,
              warmup: int = 2, stream=None) -> tuple:
    """(ms, method): the device time of one call of ``fn``, the mean over
    ``reps`` launches of the device durations that ``torch.profiler`` (CUDA
    activity) records, summed over the kernels whose name holds ``match``
    (or any of a tuple of names; every kernel without it; copies and fills
    left out). Unlike
    :func:`cuda_ms`, it holds no host time between launches, which bounds a
    mean over back-to-back launches of a kernel shorter than its wrapper's
    host work. A trace that holds no device time, or in which a kernel ran
    a number of times that is not a multiple of ``reps`` (launches missing
    from the trace), is taken again, up to three traces in all; after that
    it says so and times a CUDA graph of the ``reps`` calls with CUDA
    events instead, captured on ``stream`` (a new stream if None). Autograd
    runs a backward on the stream of its forward, so a backward is captured
    on the stream its graph was built on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (match,) if isinstance(match, str) else match
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset"))
                   and (names is None or any(m in e.key for m in names))]
        total = sum(e.self_device_time_total for e in kernels)
        if total > 0 and all(e.count % reps == 0 for e in kernels):
            return total / 1e3 / reps, "profiler"
        print(f"torch.profiler recorded an incomplete trace (kernel {match!r}: "
              f"{total / 1e3:.4f} ms, launch counts "
              f"{sorted({e.count for e in kernels})} over {reps} calls)",
              flush=True)
    print(f"timing a CUDA graph of {reps} calls instead", flush=True)
    return graph_ms(fn, reps, stream), "cuda graph"


def graph_ms(fn, reps: int = 10, stream=None) -> float:
    """The mean ms of one call of ``fn`` in a CUDA graph of ``reps`` calls,
    captured on ``stream`` (a new stream if None), by CUDA events around one
    replay."""
    import torch

    graph = torch.cuda.CUDAGraph()
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Named faults of the attention tiles (K3's core, K6), as plain emulations in
# f32: ``edge_unmasked``, the keys from S up to the next multiple of 64 enter
# with score 0 and zero V (an unmasked ragged edge); ``no_rescale``, K6's
# running accumulator is not rescaled by exp(m_old − m_new) when a 64-key
# tile raises the row max (the running sum is), or K3's core's running sum
# in the first of its two passes is not.
def pad_keys(t, dim: int, n: int):
    """``t`` with ``n`` zero rows appended along ``dim``."""
    import torch

    shape = list(t.shape)
    shape[dim] = n
    return torch.cat([t, t.new_zeros(shape)], dim)


def core_edge_unmasked(qkv, kb, heads: int, scale: float):
    from cpt_tpu_torch.ops.fused_attention import reference_attention_core

    s = qkv.shape[1]
    pad = -s % 64
    return reference_attention_core(pad_keys(qkv, 1, pad), pad_keys(kb, 1, pad),
                                    heads, scale)[:, :s]


def core_no_rescale(qkv, kb, heads: int, scale: float):
    """K3's core in its streamed branch (S > 128) with pass 1's running sum
    not rescaled by exp(m_old − m_new) when a 64-key tile raises the row
    max (the fault the two-pass schedule must not have)."""
    import torch

    b, s, h3 = qkv.shape
    q, k, v = qkv.float().reshape(b, s, 3, heads, -1).unbind(2)
    sc = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
          + kb.float()[:, None, None, :])
    m = torch.full(sc.shape[:-1], float("-inf"), device=sc.device)
    l = torch.zeros_like(m)
    for k0 in range(0, s, 64):
        st = sc[..., k0:k0 + 64]
        m = torch.maximum(m, st.amax(-1))
        l = l + torch.exp(st - m[..., None]).sum(-1)
    p = torch.exp(sc - m[..., None]) / l[..., None]
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h3 // 3)


def flash_edge_unmasked(q, k, v, kb, scale: float):
    from cpt_tpu_torch.ops.attention import reference_flash_mha

    s = q.shape[2]
    pad = -s % 64
    kb = pad_keys(kb, 3, pad)
    if kb.shape[2] > 1:
        kb = pad_keys(kb, 2, pad)
    return reference_flash_mha(*(pad_keys(t, 2, pad) for t in (q, k, v)), kb,
                               sm_scale=scale)[:, :, :s]


def flash_no_rescale(q, k, v, bias, scale: float):
    import torch

    s = (torch.einsum("bhqd,bhkd->bhqk", q, k) + bias) * scale
    m = torch.full(s.shape[:-1], float("-inf"), device=s.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, s.shape[-1], 64):
        st = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        l = l * torch.exp(m - m_new) + p.sum(-1)
        acc = acc + p @ v[:, :, k0:k0 + 64]
        m = m_new
    return acc / l[..., None]


# Named faults of the shared GEMM (``csrc/gemm.cu``) under K3's projections
# and K4, as plain emulations beside the references: ``ln_slice_stats``,
# the row LayerNorm's statistics taken per 128-column slice (the cluster's
# exchange skipped); ``k_tail_dropped``, the last 64-deep k tile of every
# product left out (a ring drained one stage early); ``no_residual``; and
# ``no_bias``, the first product's bias dropped (K4's b1, K3's QKV bias).
GEMM_FAULTS = ("ln_slice_stats", "k_tail_dropped", "no_residual", "no_bias")


def ln_slice_stats(y, gamma, beta, eps: float):
    """f32 LayerNorm of ``y`` whose mean and variance come from each
    128-column slice alone."""
    ys = y.unflatten(-1, (-1, 128))
    mu = ys.mean(-1, keepdim=True)
    var = (ys - mu).square().mean(-1, keepdim=True)
    return ((ys - mu) * (var + eps).rsqrt()).flatten(-2) * gamma + beta


def k_tail_dropped(w):
    """``w`` [K, N] with the rows of its last 64-deep k tile zeroed."""
    w = w.clone()
    w[(w.shape[0] - 1) // 64 * 64:] = 0
    return w


def _gemm_fault_parts(fault, w_in, b_in, w_out):
    import torch

    from cpt_tpu_torch.ops.fused_attention import layer_norm_f32

    if fault not in (None,) + GEMM_FAULTS:
        raise ValueError(f"unknown GEMM fault {fault!r}")
    if fault == "k_tail_dropped":
        w_in, w_out = k_tail_dropped(w_in), k_tail_dropped(w_out)
    if fault == "no_bias":
        b_in = torch.zeros_like(b_in)
    norm = ln_slice_stats if fault == "ln_slice_stats" else layer_norm_f32
    return w_in, b_in, w_out, norm, fault != "no_residual"


def ffn_with_fault(x, w1, b1, w2, b2, gamma, beta, eps: float,
                   approximate: bool, fault=None):
    """``reference_ffn`` (in x's dtype, f32 LayerNorm) with one of
    ``GEMM_FAULTS``, or none."""
    import torch.nn.functional as F

    dt = x.dtype
    w1, b1, w2, norm, residual = _gemm_fault_parts(fault, w1, b1, w2)
    h = F.gelu(x @ w1.to(dt) + b1.to(dt),
               approximate="tanh" if approximate else "none")
    y = h @ w2.to(dt) + b2.to(dt)
    if residual:
        y = y + x
    return norm(y.float(), gamma.float(), beta.float(), eps).to(dt)


def attention_block_with_fault(x, wqkv, bqkv, wo, bo, gamma, beta, key_bias,
                               heads: int, eps: float, fault=None):
    """K3's block in f32 (the projections around ``reference_attention_core``,
    which in f32 is ``reference_attention_block``) with one of
    ``GEMM_FAULTS``, or none."""
    from cpt_tpu_torch.ops.fused_attention import reference_attention_core

    b, s, h = x.shape
    x = x.float()
    wqkv, bqkv, wo, norm, residual = _gemm_fault_parts(fault, wqkv.float(),
                                                       bqkv.float(), wo.float())
    qkv = x @ wqkv + bqkv
    ctx = reference_attention_core(qkv, key_bias, heads,
                                   1.0 / float(h // heads) ** 0.5)
    y = ctx @ wo + bo.float()
    if residual:
        y = y + x
    return norm(y, gamma.float(), beta.float(), eps)


def slice_offsets(rng, h: int) -> np.ndarray:
    """A mean for each 128-column slice of a row of ``h``, spread over
    [-0.5, 0.5], so that statistics taken per slice miss the row's."""
    means = np.linspace(-0.5, 0.5, max(h // 128, 1))
    return np.repeat(rng.permutation(means), 128)[:h]


def k4_inputs(m: int, h: int, f: int, seed: int) -> list:
    """K4's inputs as f32 numpy arrays (x [m, h], w1, b1, w2, b2, gamma,
    beta), drawn so that each of ``GEMM_FAULTS`` moves the output: weights
    of std ~1/sqrt(fan in), a first bias of std 0.5, and a second bias
    whose 128-column slices have different means."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(m, h) * 0.5).astype(np.float32),
            (rng.randn(h, f) * 0.8 / h ** 0.5).astype(np.float32),
            (rng.randn(f) * 0.5).astype(np.float32),
            (rng.randn(f, h) * 1.6 / f ** 0.5).astype(np.float32),
            (rng.randn(h) * 0.1 + slice_offsets(rng, h)).astype(np.float32),
            (rng.rand(h) + 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32)]


def k3_inputs(b: int, s: int, h: int, seed: int) -> list:
    """K3's inputs as f32 numpy arrays (x [b, s, h], wqkv, bqkv, wo, bo,
    gamma, beta, key_bias): projections scaled so the scores spread (std
    ≈ 2, softmax far from uniform), a QKV bias of std 0.5, an output bias
    whose 128-column slices have different means; ~30% of the keys masked
    and the last sequence wholly."""
    rng = np.random.RandomState(seed)
    kb = np.where(rng.rand(b, s) > 0.3, 0.0, -10000.0).astype(np.float32)
    kb[-1] = -10000.0
    return [(rng.randn(b, s, h) * 0.5).astype(np.float32),
            (rng.randn(h, 3 * h) * 2.8 / h ** 0.5).astype(np.float32),
            (rng.randn(3 * h) * 0.5).astype(np.float32),
            (rng.randn(h, h) * 0.8 / h ** 0.5).astype(np.float32),
            (rng.randn(h) * 0.1 + slice_offsets(rng, h)).astype(np.float32),
            (rng.rand(h) + 0.5).astype(np.float32),
            (rng.randn(h) * 0.1).astype(np.float32), kb]


def on_card(arrays, dev) -> list:
    """``k3_inputs`` / ``k4_inputs`` as tensors on ``dev``: the activations
    and the two weights (positions 0, 1 and 3) bf16, the rest f32."""
    import torch

    return [torch.from_numpy(a).to(dev).to(torch.bfloat16 if i in (0, 1, 3)
                                          else torch.float32)
            for i, a in enumerate(arrays)]


# K1's shapes: the X152 grouped 3×3 of every stage for 8 copies on the
# 640×1024 canvas (stage 5: 8 copies × 8 RoIs), 32 groups
K1_SHAPES = [(8, 160, 256, 256, 1), (8, 160, 256, 512, 2), (8, 80, 128, 512, 1),
             (8, 80, 128, 1024, 2), (8, 40, 64, 1024, 1), (64, 14, 14, 2048, 2),
             (64, 7, 7, 2048, 1)]
# A shape that only K1's CUDA-core kernel takes (cpg 4; the tensor-core
# kernel needs cpg 8-64): stage 2 of a ResNeXt 32×4d on the same canvas
K1_SIMT_SHAPE = (8, 160, 256, 128, 1)


def k1_inputs(n: int, h: int, w: int, c: int, g) -> tuple:
    """K1's inputs at one shape, 32 groups, drawn from generator ``g`` on
    its device: x (ReLU'd) and the HWIO weights in bf16, the f32 scale and
    bias. The weights carry a per-tap mean that is not symmetric in (ky,
    kx), so transposed taps shift every output; the bias is as large as a
    trained BN's."""
    import torch

    dev, bf = g.device, torch.bfloat16
    x = torch.relu(torch.randn(n, h, w, c, generator=g, device=dev).to(bf))
    tap_mean = torch.linspace(-0.03, 0.03, 9, device=dev).view(3, 3, 1, 1)
    wt = (torch.randn(3, 3, c // 32, c, generator=g, device=dev) * 0.05
          + tap_mean).to(bf)
    s = torch.rand(c, generator=g, device=dev) + 0.5
    b = torch.randn(c, generator=g, device=dev) * 0.5
    return x, wt, s, b


def k1_faults(x, wt, s, b, groups: int, stride: int) -> dict:
    """K1's named faults: each the plain version on the same inputs with one
    indexing slip a rewrite could make, as a function to call. Input
    channels from the neighbouring group (x's group axis rolled by one);
    the 3×3 taps transposed (ky ↔ kx); the bias dropped; and, at stride 2,
    the sampling grid one input pixel off (rows and columns 1, 3, 5, ... of
    the stride-1 output, zero past its edge, in place of 0, 2, 4, ...)."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.grouped_conv import reference_grouped_conv3x3

    n, h, w, c = x.shape

    def plain(xx=x, ww=wt, bb=b, st=stride):
        return lambda: reference_grouped_conv3x3(xx, ww, s, bb, groups, st,
                                                 True)

    faults = {"neighbour_group": plain(xx=x.reshape(n, h, w, groups, -1)
                                       .roll(1, 3).reshape(n, h, w, c)),
              "taps_transposed": plain(ww=wt.transpose(0, 1)),
              "no_bias": plain(bb=torch.zeros_like(b))}
    if stride == 2:
        ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        faults["grid_shifted"] = lambda: F.pad(plain(st=1)(), (
            0, 0, 0, 1, 0, 1))[:, 1:2 * ho:2, 1:2 * wo:2]
    return faults


# Named faults of K2 (RoIAlign), as plain emulations in f32 beside
# ``batched_roi_align_plain``: ``aligned``, the half-pixel offset −0.5 and
# no minimum RoI extent of 1 (torchvision's aligned=True); ``fixed_grid``, a
# fixed 2×2 sampling grid in place of ceil(bin) capped at max_sampling (a
# fault of the adaptive grid only); ``clamp_not_skip``, samples outside
# [-1, size] clamped to the edge instead of dropped; ``count_in_range``, the
# average over the in-range samples in place of sy·sx. Each shows on a RoI
# that reaches past the map with bins of more than two samples.
K2_FAULTS = ("aligned", "fixed_grid", "clamp_not_skip", "count_in_range")


def _k2_axis(start, extent, size: int, pooled: int, sampling: int,
             max_sampling: int, fault):
    """R [N, pooled, size]: one axis's folded interpolation rows
    (``ops/roi_align._interp_matrix`` in f32) with ``fault``."""
    import torch

    bins = (extent if fault == "aligned" else extent.clamp(min=1.0)) / pooled
    if fault == "fixed_grid":
        s_n, smax = torch.full_like(bins, 2.0), 2
    elif sampling:
        s_n, smax = torch.full_like(bins, float(sampling)), sampling
    else:
        s_n, smax = torch.clamp(torch.ceil(bins), 1, max_sampling), max_sampling
    s_n = s_n[:, None, None]
    dev = start.device
    p_idx = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    s_idx = torch.arange(smax, dtype=torch.float32, device=dev)[None, None, :]
    pos = start[:, None, None] + (p_idx + (s_idx + 0.5) / s_n) * bins[:, None, None]
    live = s_idx < s_n
    in_range = live if fault == "clamp_not_skip" else (
        (pos >= -1.0) & (pos <= size) & live)
    pos = pos.clamp(0.0, size - 1)
    low = torch.floor(pos)
    frac = pos - low
    low = low.to(torch.int64)
    high = (low + 1).clamp(max=size - 1)
    grid = torch.arange(size, device=dev)
    rows = ((1.0 - frac) * in_range)[..., None] * (grid == low[..., None]) + (
        frac * in_range)[..., None] * (grid == high[..., None])
    count = (in_range.sum(2, keepdim=True).clamp(min=1).float()
             if fault == "count_in_range" else s_n)
    return rows.sum(dim=2) / count


def roi_align_with_fault(feats, rois, spatial_scale: float, pooled: int = 14,
                         sampling: int = 0, max_sampling: int = 8, fault=None):
    """``batched_roi_align_plain`` in f32 with one of K2_FAULTS (None: the
    plain version itself)."""
    import torch

    from cpt_tpu_torch.ops.roi_align import separable_pool

    if fault not in (None,) + K2_FAULTS:
        raise ValueError(f"unknown K2 fault {fault!r}")
    _, h, w, _ = feats.shape
    r = rois.float() * spatial_scale
    if fault == "aligned":
        r = r - 0.5
    ry = _k2_axis(r[:, 1], r[:, 3] - r[:, 1], h, pooled, sampling,
                  max_sampling, fault)
    rx = _k2_axis(r[:, 0], r[:, 2] - r[:, 0], w, pooled, sampling,
                  max_sampling, fault)
    return separable_pool(feats.to(torch.float32), ry, rx)


def k2_faults(feats, rois, spatial_scale: float, pooled: int, sampling: int,
              max_sampling: int) -> dict:
    """K2's named faults that apply to this grid (``fixed_grid`` only to
    the adaptive one), each as a function computing it."""
    return {f: (lambda f=f: roi_align_with_fault(
        feats, rois, spatial_scale, pooled, sampling, max_sampling, f))
        for f in K2_FAULTS if not (f == "fixed_grid" and sampling)}


def k2_shapes() -> list:
    """K2's main-path launches at scale 1/16, 14×14, adaptive grid capped
    at 8, as (label, feats shape, rois [N, 4] numpy f32 in image pixels):
    the 16-candidate grounding request (boxes drawn as phase 4 draws them
    on the 480×640 image, scaled by 4/3 to the 640×1024 canvas); the
    detect step's box head (300 proposals on the 1024×1024 canvas); one
    launch of the ``--detect`` request's grounding (its chunk of 128
    copies, ``head_chunk`` 32 of its 128 det slots); and 8 copies × 8 / 32
    RoIs, the first wider than the canvas, so its grid hits the 8-sample
    cap. The launcher picks its code by shape: one copy (the box head)
    takes one block over all channels, the rest 128-channel slices in
    groups of copies."""
    rng = np.random.RandomState(7)

    def boxes(n, lo, hi, size_lo, size_hi, scale=1.0):
        xy = rng.uniform(lo, hi, (n, 2))
        return (np.concatenate([xy, xy + rng.uniform(size_lo, size_hi, (n, 2))], 1)
                * scale).astype(np.float32)

    out = [("request", (16, 40, 64, 1024), boxes(16, 0, 400, 24, 240, 4 / 3)),
           ("detect box head", (1, 64, 64, 1024), boxes(300, 0, 900, 8, 300)),
           ("--detect grounding", (128, 40, 64, 1024), boxes(32, 0, 400, 24, 240,
                                                             4 / 3))]
    for n in (8, 32):
        r = np.random.RandomState(n)
        xy = r.uniform(0, 600, (n, 2))
        rois = np.concatenate([xy, xy + r.uniform(16, 420, (n, 2))], 1).astype(
            np.float32)
        rois[0] = [-300.0, -200.0, 1500.0, 1000.0]
        out.append((f"{n} RoIs", (8, 40, 64, 1024), rois))
    return out


def _k2_taps(start, extent, size: int, pooled: int, s) -> list:
    """Per RoI, the indices along one axis that its folded tables read
    (weight > 0), with the legacy rules in f32 as ``csrc/roi_align.cu``
    folds them: start [N], extent [N], samples a side s [N]."""
    f32 = np.float32
    bins = np.maximum(extent, f32(1)) / f32(pooled)
    taps = []
    for n in range(len(start)):
        sn = int(s[n])
        pos = (start[n] + (np.arange(pooled, dtype=f32)[:, None]
                           + (np.arange(sn, dtype=f32)[None] + f32(0.5)) / f32(sn))
               * bins[n]).ravel()
        pos = np.clip(pos[(pos >= -1) & (pos <= size)], 0, size - 1)
        lo = np.floor(pos)
        taps.append(np.union1d(lo, lo[pos > lo] + 1).astype(np.int64))
    return taps


def k2_work(shape, rois, spatial_scale: float, pooled: int = 14,
            sampling: int = 0, max_sampling: int = 8) -> tuple:
    """(bytes, operations) for K2's bound on feats ``shape`` [B, H, W, C]
    bf16 and ``rois`` [N, 4] numpy f32: every feature pixel that some RoI's
    folded tables read, read once (the union over the RoIs of their
    rows × columns), the RoIs read and the bf16 output written once; and
    the plain version's work, 4 bilinear taps (a multiply-add each) a
    sample for every channel."""
    b, h, w, c = shape
    r = rois.astype(np.float32) * np.float32(spatial_scale)
    ext = np.maximum(r[:, 2:] - r[:, :2], np.float32(1)) / np.float32(pooled)
    s = (np.full(ext.shape, sampling) if sampling
         else np.clip(np.ceil(ext), 1, max_sampling))
    ys = _k2_taps(r[:, 1], r[:, 3] - r[:, 1], h, pooled, s[:, 1])
    xs = _k2_taps(r[:, 0], r[:, 2] - r[:, 0], w, pooled, s[:, 0])
    read = np.zeros((h, w), bool)
    for y, x in zip(ys, xs):
        read[np.ix_(y, x)] = True
    n = len(rois)
    n_bytes = b * int(read.sum()) * c * 2 + rois.nbytes + b * n * pooled ** 2 * c * 2
    return n_bytes, b * c * pooled ** 2 * float(s.prod(1).sum()) * 4 * 2


def zero_counts(counters) -> None:
    """Every counter to 0 (K1's count per path too)."""
    for fn in counters.values():
        fn.launches = 0
        for path in getattr(fn, "path_launches", {}):
            fn.path_launches[path] = 0


def k1_paths(counters, launches: dict, where: str, key: str = "K1") -> dict:
    """K1's (or, with ``key`` "K1q", K1q's) launches per path since the
    counts were zeroed; raises unless every one went through the path the
    dispatch rule names for the X152 shapes (``ops/grouped_conv.conv_path``)."""
    from cpt_tpu_torch.ops.grouped_conv import conv_path

    paths = dict(counters[key].path_launches)
    want = {conv_path(c, c // 32) for c in (256, 512, 1024, 2048)}
    if sum(paths[p] for p in want) != launches[key] or any(
            paths[p] for p in paths if p not in want):
        raise AssertionError(f"{where}: {key} launches by path {paths}, "
                             f"{launches[key]} in all; the rule names "
                             f"{sorted(want)}")
    return paths


def compare(name: str, label: str, kernel, plain, exact, rows: list,
            faults: dict | None = None, work: tuple = (0, 0, BF16_OPS_S),
            library=None, device: str | None = None) -> None:
    """Check the kernel's max |Δ| against ``exact()`` (the plain version in
    f32 on the same inputs) within the tolerance, then time the kernel,
    ``plain()`` (the plain version in the kernel's dtype) and ``library()``
    (one PyTorch call computing the same function, or None) over their own
    loops of launches. ``faults`` maps a named fault (uniform attention, a
    dropped mask, ...) to the reference computed with that fault: each must
    miss the tolerance, which shows the check can fail. ``work`` is
    (bytes moved, operations, peak operations/s of their type) for the
    bound. Given ``device`` (the kernel's name), the kernel and ``library``
    are also timed by device time (:func:`device_ms`)."""
    import torch

    t_check = time.perf_counter()
    got = kernel()
    want = exact()
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name} {label}: non-finite output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = TOL[name] * max(scale, 1e-3)
    fault_errs = {f: float((fn().float() - want).abs().max())
                  for f, fn in (faults or {}).items()}
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    library_ms = None if library is None else cuda_ms(library)
    bound_ms, bound_by = bound(*work)
    rows.append({"kernel": name, "shape": label, "max_abs_err": err,
                 "tol": tol, "max_abs_ref": scale, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "fault_errs": fault_errs})
    dev_txt = ""
    if device is not None:
        rows[-1]["device_ms"], how = device_ms(kernel, device)
        dev_txt = f" device_ms={rows[-1]['device_ms']:.4f}"
        if library is not None:
            rows[-1]["library_device_ms"], _ = device_ms(library)
            dev_txt += f" library_device_ms={rows[-1]['library_device_ms']:.4f}"
        dev_txt += f" (device time by {how})"
    faults_txt = "".join(f" {f}={e:.3e} ({e / tol:.1f}x tol)"
                         for f, e in fault_errs.items())
    lib_txt = "" if library_ms is None else f" library_ms={library_ms:.4f}"
    rows[-1]["wall_s"] = time.perf_counter() - t_check
    print(f"{name} {label}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"({tol / max(err, 1e-30):.1f}x err) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}{lib_txt} bound_ms={bound_ms:.4f} "
          f"({bound_by}){dev_txt}{faults_txt}; the check "
          f"{rows[-1]['wall_s']:.1f} s", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")
    caught = [f for f, e in fault_errs.items() if not e > tol]
    if caught:
        raise AssertionError(f"{name} {label}: the check would pass {caught}")


def check_k1(rows: list, shapes, g, device=None) -> None:
    """K1 against its plain version in f32 and its named faults
    (``k1_faults``) at each of ``shapes`` ((n, h, w, c, stride), 32 groups),
    with ``F.conv2d(groups=32)`` as its yardstick; given ``device`` (kernel
    name patterns), by device time too."""
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.grouped_conv import (conv_path, grouped_conv3x3,
                                                reference_grouped_conv3x3)

    for n, h, w, c, stride in shapes:
        groups = 32
        cpg = c // groups
        x, wt, s, b = k1_inputs(n, h, w, c, g)
        out_px = n * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous()
        x_nchw = x.permute(0, 3, 1, 2)       # channels-last NCHW view
        xf, wf = x.float(), wt.float()

        path = conv_path(c, cpg)
        compare("K1", f"x=[{n},{h},{w},{c}] cpg={cpg} stride={stride} "
                f"path={path}",
                lambda: grouped_conv3x3(x, wt, s, b, groups, stride, True),
                lambda: reference_grouped_conv3x3(x, wt, s, b, groups, stride,
                                                  True),
                lambda: reference_grouped_conv3x3(xf, wf, s, b, groups, stride,
                                                  True),
                rows, k1_faults(xf, wf, s, b, groups, stride),
                work=(nbytes(x, wt, s, b) + out_px * c * 2,
                      2 * out_px * c * 9 * cpg, BF16_OPS_S),
                library=lambda: F.conv2d(x_nchw, w_oihw, stride=stride,
                                         padding=1, groups=groups),
                device=device)
        rows[-1]["path"] = path


def check_k3(rows: list, b: int, s_len: int, hdim: int = 768,
             heads: int = 12) -> None:
    """K3's block at [b, s_len, hdim] (``heads`` heads; Oscar-base's 768 and
    12 by default) and its attention core alone,
    each against its plain version in f32, by device time. The projections
    are scaled so the scores spread (std ≈ 2): softmax is far from uniform,
    so uniform attention or a dropped mask misses the tolerance, and so does
    each of the GEMM's named faults (``k3_inputs``); the last sequence has
    every key masked. The core alone runs on a packed projection of std 1.5
    beside SDPA; where S is not a multiple of 64 the keys past S entering
    unmasked (``core_edge_unmasked``) must miss too. Above S = 128 the core
    takes its streamed two-pass branch, where pass 1's running sum left
    unrescaled (``core_no_rescale``) must miss as well."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.kernels.gemm import attention_core
    from cpt_tpu_torch.ops.fused_attention import (fused_attention_block,
                                                   reference_attention_block,
                                                   reference_attention_core)

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(s_len)
    hd = hdim // heads
    scale = 1.0 / hd ** 0.5
    args = on_card(k3_inputs(b, s_len, hdim, seed=s_len), dev)
    x, kb = args[0], args[7]

    def f32(a):
        return [t.float() for t in a]

    no_q = f32(args)
    no_q[1][:, :hdim] = 0.0
    no_q[2][:hdim] = 0.0
    no_mask = f32(args)
    no_mask[7] = torch.zeros_like(kb)

    def block_ref(a, fault=None):
        return lambda: attention_block_with_fault(*a, heads, 1e-12, fault)

    faults = {"uniform": block_ref(no_q), "no_mask": block_ref(no_mask)}
    faults.update({f: block_ref(f32(args), f) for f in GEMM_FAULTS})
    tokens = b * s_len
    compare("K3", f"x=[{b},{s_len},{hdim}] heads={heads}",
            lambda: fused_attention_block(*args, heads, 1e-12),
            lambda: reference_attention_block(*args, num_heads=heads,
                                              eps=1e-12),
            lambda: reference_attention_block(*f32(args), num_heads=heads,
                                              eps=1e-12), rows, faults,
            work=(nbytes(*args) + nbytes(x),
                  2 * tokens * hdim * 4 * hdim + 4 * tokens * s_len * hdim,
                  BF16_OPS_S),
            device=("wgmma_", "attention_kernel"))

    qkv = (torch.randn(b, s_len, 3 * hdim, generator=g, device=dev) * 1.5).to(bf)
    qkv_no_q = qkv.clone()
    qkv_no_q[..., :hdim] = 0

    def core_ref(q, bias, sc):
        return lambda: reference_attention_core(q, bias, heads, sc)

    qh, kh, vh = qkv.view(b, s_len, 3, heads, hd).unbind(2)
    kb_mask = kb[:, None, None, :].to(bf)
    core_faults = {"uniform": core_ref(qkv_no_q, kb, scale),
                   "no_mask": core_ref(qkv, torch.zeros_like(kb), scale),
                   "no_scale": core_ref(qkv, kb, 1.0)}
    if s_len % 64:
        core_faults["edge_unmasked"] = lambda: core_edge_unmasked(
            qkv, kb, heads, scale)
    if s_len > 128:
        core_faults["no_rescale"] = lambda: core_no_rescale(qkv, kb, heads,
                                                            scale)
    compare("K3 core", f"qkv=[{b},{s_len},{3 * hdim}] heads={heads}",
            lambda: attention_core(qkv, kb, heads, scale),
            core_ref(qkv, kb, scale), core_ref(qkv, kb, scale), rows,
            core_faults,
            work=(nbytes(qkv, kb) + tokens * hdim * 2,
                  4 * tokens * s_len * hdim, BF16_OPS_S),
            library=lambda: F.scaled_dot_product_attention(
                qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                attn_mask=kb_mask, scale=scale),
            device="attention_kernel")


def check_k4(rows: list, m: int, approx: bool = False, hdim: int = 768,
             f: int = 3072) -> None:
    """K4 at [m, hdim], FFN width f (Oscar-base's 768 and 3072 by default;
    ``k4_inputs``), against its plain version in f32 with each of
    ``GEMM_FAULTS``, by device time (the split LayerNorm path's row kernel
    too, past a hidden size of 1024)."""
    import torch

    from cpt_tpu_torch.ops.fused_ffn import fused_ffn, reference_ffn

    args = on_card(k4_inputs(m, hdim, f, seed=m), torch.device("cuda"))
    fargs = [a.float() for a in args]

    def ffn_ref(a, fault=None):
        return lambda: ffn_with_fault(*a, 1e-12, approx, fault)

    compare("K4", f"x=[{m},{hdim}] F={f} gelu={'tanh' if approx else 'erf'}",
            lambda: fused_ffn(*args, approximate=approx),
            lambda: reference_ffn(*args, 1e-12, approx),
            lambda: reference_ffn(*fargs, 1e-12, approx), rows,
            {fault: ffn_ref(fargs, fault) for fault in GEMM_FAULTS},
            work=(nbytes(*args) + nbytes(args[0]), 4 * m * hdim * f,
                  BF16_OPS_S),
            device=("wgmma_", "residual_ln_rows"))


def check_kernels(rows: list) -> None:
    import torch

    from cpt_tpu_torch.kernels.gemm import gemm_bias_act
    from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                    batched_roi_align_plain)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    hdim = 768

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    # K1 at the X152 bottleneck shapes of an 8-copy request on the
    # 640×1024 canvas (stage 5 at 8 copies × 8 RoIs), on the path the
    # dispatch rule names (the tensor-core kernel at every one of them),
    # then at a shape that only the CUDA-core kernel takes
    check_k1(rows, K1_SHAPES + [K1_SIMT_SHAPE], g)

    # K2 at each of its main-path launches (the request, the box head's
    # single copy, the --detect grounding chunk) and on 8 copies with a RoI
    # wider than the canvas, so every code the launcher picks by shape is
    # held to the plain version and to the named faults
    for label, shape, rois in k2_shapes():
        feats = randn(*shape)
        rois_t = torch.from_numpy(rois).to(dev)
        compare("K2", f"{label}: feats={list(shape)} rois={len(rois)}",
                lambda: batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8),
                lambda: batched_roi_align_plain(feats, rois_t, 1 / 16.0, 14,
                                                0, 8),
                lambda: batched_roi_align_plain(feats.float(), rois_t,
                                                1 / 16.0, 14, 0, 8), rows,
                k2_faults(feats, rois_t, 1 / 16.0, 14, 0, 8),
                work=k2_work(shape, rois, 1 / 16.0) + (F32_OPS_S,),
                device="roi_align")
        del feats
        torch.cuda.empty_cache()

    # the scene-graph path's new launch shapes: the relation head's stage 5
    # over 240 union boxes (every ordered pair of 16 detections) and their
    # pooling from the 1024×1024 canvas's C4 map (one copy)
    check_k1(rows, K1_UNION_SHAPES, g)
    feats = randn(1, 64, 64, 1024)
    rois = sg_union_rois()
    rois_t = torch.from_numpy(rois).to(dev)
    compare("K2", f"scene-graph union boxes: feats=[1,64,64,1024] rois={len(rois)}",
            lambda: batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8),
            lambda: batched_roi_align_plain(feats, rois_t, 1 / 16.0, 14, 0, 8),
            lambda: batched_roi_align_plain(feats.float(), rois_t, 1 / 16.0, 14,
                                            0, 8), rows,
            k2_faults(feats, rois_t, 1 / 16.0, 14, 0, 8),
            work=k2_work(tuple(feats.shape), rois, 1 / 16.0) + (F32_OPS_S,),
            device="roi_align")
    del feats
    torch.cuda.empty_cache()

    # K3 at the scoring shape: 16 sequences of 70 text + 50 region slots,
    # and S = 128
    for s_len in (120, 128):
        check_k3(rows, 16, s_len)
    # K4 on 8 sequences × 120 slots, on the scoring batch's 16 × 120 (the
    # main path's shape) and on 16 × 79 rows (ragged at the 128- and
    # 64-row tiles); erf gelu, and tanh once
    for m, approx in ((960, False), (960, True), (1920, False), (1264, False)):
        check_k4(rows, m, approx)

    # epilogue (a) alone at the QKV and FFN-1 shapes of the scoring batch,
    # beside torch.addmm, the one PyTorch call that computes it
    for name, n in (("K3 gemm", 3 * hdim), ("K4 gemm", 3072)):
        a = randn(1920, hdim, scale=0.5)
        w = randn(hdim, n, scale=0.8 / hdim ** 0.5)
        b = randn(n, scale=0.5, dtype=torch.float32)
        b_bf = b.to(bf)
        af, wf = a.float(), w.float()
        compare(name, f"a=[1920,768] w=[768,{n}] epilogue (a)",
                lambda: gemm_bias_act(a, w, b), lambda: a @ w + b_bf,
                lambda: af @ wf + b, rows,
                {"k_tail_dropped": lambda: af @ k_tail_dropped(wf) + b,
                 "no_bias": lambda: af @ wf},
                work=(nbytes(a, w, b) + 1920 * n * 2, 2 * 1920 * hdim * n,
                      BF16_OPS_S),
                library=lambda: torch.addmm(b_bf, a, w),
                device=("wgmma_bias_act",))
    check_nms(rows)
    check_flash(rows)
    check_flash_bwd(rows)
    check_k1q(rows)
    check_k7(rows)


# Named faults of K5 (greedy NMS): ``ge`` suppresses at IoU >= thr,
# ``ties_high`` breaks score ties to the higher index, ``no_valid`` ignores
# the validity mask, and ``chain`` lets a suppressed box still suppress (a
# bitmask scan that ORs every row, not only the kept ones).
NMS_FAULTS = ("ge", "ties_high", "no_valid", "chain")


def nms_inputs(b: int, k: int, thr: float, offset: float = 0.0,
               ones: bool = False, seed: int = 0) -> tuple:
    """numpy (boxes [b, k, 4] f32, scores [b, k] f32, valid [b, k] bool):
    random boxes on a 900×900 field at 21 score levels (all 1.0 with
    ``ones``, as the random detector scores), a fifth invalid, and, clear of
    them at the head of the order (score 1.0, ties broken by index, k >=
    19), 8 pairs at IoU exactly ``thr`` under ``offset`` and a chain A, B, C
    shifted along x with IoU(A, B) and IoU(B, C) > thr >= IoU(A, C), so that
    C survives."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 900, (b, k, 2))
    wh = rng.uniform(8, 300, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (np.ones((b, k)) if ones else rng.randint(0, 21, (b, k)) / 20
              ).astype(np.float32)
    valid = rng.rand(b, k) > 0.2
    o = offset
    # [x, y, x+10, y+10] / [x, y, x+10, y+10·thr] in widths of the
    # convention: exclusive IoU exactly thr
    for p in range(8):
        x0, y0 = 1300.0 + 20 * p, 1300.0
        boxes[:, 2 * p] = [x0, y0, x0 + 10 - o, y0 + 10 - o]
        boxes[:, 2 * p + 1] = [x0, y0, x0 + 10 - o, y0 + 10 * thr - o]
    # 10-wide squares shifted by d: IoU (10 − d) / (10 + d), = thr at
    # d0 = 10 (1 − thr) / (1 + thr); d = 0.75 d0 puts A-B and B-C above it
    # and A-C (2d) below
    d = 7.5 * (1 - thr) / (1 + thr)
    for q in range(3):
        x0 = 1480.0 + q * d
        boxes[:, 16 + q] = [x0, 1300.0, x0 + 10 - o, 1310.0 - o]
    scores[:, :19] = 1.0
    valid[:, :19] = True
    return boxes, scores, valid


def _chain_nms(boxes, scores, valid, thr, max_out, offset):
    """The ``chain`` fault: a box is kept iff no live box before it in the
    order (score descending, index ascending) overlaps it > thr, kept or
    not; the first ``max_out`` kept in that order."""
    import torch

    from cpt_tpu_torch.ops.nms import NEG_INF

    live = torch.where(valid, scores, NEG_INF)
    eligible = live > NEG_INF / 2
    b, k = scores.shape
    order = torch.sort(-live, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(k, device=boxes.device).expand(b, k))
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0] + offset, min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1] + offset, min=0))
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(rb - lt + offset, min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area[:, :, None] + area[:, None, :] - inter,
                              min=1e-10)
    # hit[b, j, i]: live j comes before i and overlaps it
    hit = (eligible[:, :, None] & (rank[:, :, None] < rank[:, None, :])
           & (iou > thr))
    kept = eligible & ~hit.any(1)
    ks = kept.gather(1, order)
    slot = ks.long().cumsum(1) - 1
    slot = torch.where(ks & (slot < max_out), slot, max_out)
    out_idx = torch.zeros((b, max_out + 1), dtype=torch.int64,
                          device=boxes.device).scatter_(1, slot, order)
    out_keep = torch.zeros((b, max_out + 1), dtype=torch.bool,
                           device=boxes.device).scatter_(1, slot, ks)
    return out_idx[:, :max_out].to(torch.int32), out_keep[:, :max_out]


def nms_with_fault(boxes, scores, valid, thr, max_out, fault, offset=0.0):
    """The plain greedy loop of ``ops/nms.py`` on [B, K] problems with one
    of NMS_FAULTS."""
    import torch

    from cpt_tpu_torch.ops.nms import NEG_INF, _iou_row

    if fault not in NMS_FAULTS:
        raise ValueError(f"unknown K5 fault {fault!r}")
    if fault == "chain":
        return _chain_nms(boxes, scores, valid, thr, max_out, offset)
    if fault == "no_valid":
        valid = torch.ones_like(valid)
    live = torch.where(valid, scores, NEG_INF)
    b, k = scores.shape
    rows = torch.arange(b, device=boxes.device)
    out_idx = torch.zeros((b, max_out), dtype=torch.int32, device=boxes.device)
    out_keep = torch.zeros((b, max_out), dtype=torch.bool, device=boxes.device)
    for i in range(max_out):
        pick = (k - 1 - torch.argmax(live.flip(1), dim=1) if fault == "ties_high"
                else torch.argmax(live, dim=1))
        ok = live[rows, pick] > NEG_INF / 2
        iou = _iou_row(boxes[rows, pick], boxes, offset)
        hit = iou >= thr if fault == "ge" else iou > thr
        live = torch.where(ok[:, None] & hit, NEG_INF, live)
        live[rows, pick] = NEG_INF
        out_idx[:, i] = torch.where(ok, pick, 0).to(torch.int32)
        out_keep[:, i] = ok
    return out_idx, out_keep


# K5's shapes (problems, K, max_out, thr, iou_offset, scores all 1.0): the
# RPN's 6000 → 300, the fast filter's 300 → 100 (NMS_FILTER 2), the
# per-class filter's [1594, 300] → 32 and the "peter" filter's
# [1594, 300] → 300 (max_out above the survivors), then the RPN's shape
# under the legacy +1 IoU with the random detector's scores, all 1.0
NMS_SHAPES = [(1, 6000, 300, 0.7, 0.0, False), (1, 300, 100, 0.5, 0.0, False),
              (1594, 300, 32, 0.5, 0.0, False), (1594, 300, 300, 0.3, 0.0, False),
              (1, 6000, 300, 0.7, 1.0, True)]


def nms_label(b: int, k: int, max_out: int, thr: float, offset: float,
              ones: bool) -> str:
    shape = f"[{k},4]" if b == 1 else f"[{b},{k},4]"
    return (f"boxes={shape} max_out={max_out} thr={thr}"
            + (f" offset={offset:g}" if offset else "")
            + (" scores=1" if ones else ""))


def check_nms(rows: list, shapes=NMS_SHAPES) -> None:
    """K5 against the plain ``nms_padded`` on the card, on the same f32
    inputs (``nms_inputs``), at ``shapes`` (NMS_SHAPES): :func:`check_nms_on`
    each."""
    for b, k, max_out, thr, off, ones in shapes:
        check_nms_on(rows, nms_label(b, k, max_out, thr, off, ones),
                     nms_inputs(b, k, thr, off, ones, seed=k + b), thr,
                     max_out, off)


def check_nms_on(rows: list, label: str, arrays: tuple, thr: float,
                 max_out: int, off: float = 0.0) -> None:
    """K5 against the plain ``nms_padded`` on the card on the numpy inputs
    ``arrays`` (boxes [b, k, 4] f32, scores [b, k], valid [b, k]; one
    problem is passed unbatched). The check is exact equality of ``keep``
    and of the kept indices. The inputs have many tied scores, pairs
    planted at IoU exactly the threshold, a suppression chain and a fifth
    of the boxes invalid (``nms_inputs``), so each of NMS_FAULTS changes the
    result; the check asserts that it does."""
    import torch

    from cpt_tpu_torch.ops.nms import nms_padded
    from cpt_tpu_torch.ops.nms_pallas import nms_pallas

    dev = torch.device("cuda")
    bx, sc, va = (torch.from_numpy(a).to(dev) for a in arrays)
    b, k = sc.shape
    args = ((bx[0], sc[0], va[0]) if b == 1 else (bx, sc, va))

    def flat(out):
        idx, keep = out
        return idx.reshape(b, -1), keep.reshape(b, -1)

    got_idx, got_keep = flat(nms_pallas(*args, thr, max_out, off))
    want_idx, want_keep = flat(nms_padded(*args, thr, max_out, off))
    torch.cuda.synchronize()
    err = float((got_idx - want_idx).abs().max())
    same = (torch.equal(got_keep, want_keep)
            and torch.equal(got_idx[got_keep], want_idx[want_keep]))

    def differs(out):
        idx, keep = out
        return not (torch.equal(keep, want_keep)
                    and torch.equal(idx[keep], want_idx[want_keep]))

    faults = {f: differs(nms_with_fault(bx, sc, va, thr, max_out, f, off))
              for f in NMS_FAULTS}
    ms = cuda_ms(lambda: nms_pallas(*args, thr, max_out, off))
    dev_ms, how = device_ms(lambda: nms_pallas(*args, thr, max_out, off),
                            "nms_")
    # the plain version, a host-bound loop, takes up to ~2 s a call: one
    # call, no warm-up
    plain_ms = cuda_ms(lambda: nms_padded(*args, thr, max_out, off),
                       reps=1, warmup=0)
    kept = int(want_keep.sum())
    # each kept box is scored against all K boxes of its problem: an
    # IoU is ~12 f32 operations (areas, intersection, union, divide)
    bound_ms, bound_by = bound(nbytes(bx, sc, va) + b * max_out * 5,
                               kept * k * 12, F32_OPS_S)
    rows.append({"kernel": "K5", "shape": label, "max_abs_err": err,
                 "tol": 0.0, "exact": same, "kept": kept, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms,
                 "library_ms": None, "bound_ms": bound_ms,
                 "bound_by": bound_by, "faults_differ": faults})
    print(f"K5 {label}: exact={same} max_abs_idx_err={err:.0f} "
          f"kept={kept} ms={ms:.4f} device_ms={dev_ms:.4f} ({how}) "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) "
          f"faults differ: {faults}", flush=True)
    if not same:
        raise AssertionError(f"K5 {label}: kernel differs from plain")
    caught = [f for f, d in faults.items() if not d]
    if caught:
        raise AssertionError(f"K5 {label}: the check would pass {caught}")


# K6's and K6b/K6c's shapes on phase 3's paths: serving (the backward at
# the training batch), a finite 3-D bias, long context; (b, heads, S, bias)
# at head_dim 64, or (b, heads, S, bias, head_dim)
FLASH_SHAPES = [(16, 12, 120, "key"), (4, 12, 512, "3d"), (2, 12, 2048, "key")]
FLASH_BWD_SHAPES = [(32, 12, 120, "key"), (4, 12, 512, "3d"),
                    (2, 12, 2048, "key")]


def check_flash(rows: list, shapes=FLASH_SHAPES) -> None:
    """K6 at the serving shape (16 sequences of 70 text + 50 region slots,
    a 0/−10000 key bias with ~20% of keys masked and the last sequence fully
    masked), with a finite [4, 1, 512, 512] bias of std 4, and at long
    context (S = 2048, key bias). q is drawn so the scores have std ≈ 2.
    Named faults: uniform attention (q dropped), a dropped bias, a dropped
    scale, where the bias is finite the bias added after the scale (the
    einsum order; a 0/−10000 mask masks in either order), at S = 120 the
    keys past S unmasked (``edge_unmasked``) and at S = 2048 the running
    accumulator not rescaled (``no_rescale``)."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.attention import flash_mha, reference_flash_mha

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    for b, h, s_len, bias, *dim in shapes:
        d = dim[0] if dim else 64
        q, k, v = (torch.randn(b, h, s_len, d, generator=g, device=dev)
                   for _ in range(3))
        q, k, v = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16()
        if bias == "key":
            kb = torch.where(torch.rand(b, 1, 1, s_len, generator=g,
                                        device=dev) > 0.2, 0.0, -10000.0)
            kb[-1] = -10000.0
        else:
            kb = torch.randn(b, 1, s_len, s_len, generator=g, device=dev) * 4
        scale = 1.0 / d ** 0.5
        qf, kf, vf = q.float(), k.float(), v.float()

        def plain(qq, kk, vv, bb, sc=scale):
            return lambda: reference_flash_mha(qq, kk, vv, bb, sm_scale=sc)

        faults = {"uniform": plain(qf * 0, kf, vf, kb),
                  "no_bias": plain(qf, kf, vf, None),
                  "no_scale": plain(qf, kf, vf, kb, 1.0)}
        if bias == "3d":
            faults["bias_after_scale"] = plain(qf, kf, vf, kb / scale)
        if bias == "key" and s_len % 64:
            faults["edge_unmasked"] = lambda: flash_edge_unmasked(qf, kf, vf, kb,
                                                                  scale)
        if s_len >= 2048:
            faults["no_rescale"] = lambda: flash_no_rescale(qf, kf, vf, kb, scale)
        mask = (kb * scale).bfloat16()
        compare("K6", f"q=[{b},{h},{s_len},{d}] bias={list(kb.shape)}",
                lambda: flash_mha(q, k, v, kb, sm_scale=scale),
                plain(q, k, v, kb), plain(qf, kf, vf, kb), rows, faults,
                work=(nbytes(q, k, v, kb) + nbytes(q),
                      4 * b * h * s_len * s_len * d, BF16_OPS_S),
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=scale),
                device="flash_attention_kernel")


def flash_bwd_with_fault(q, k, v, bias, do, scale, fault=None):
    """(dq, dk, dv) of softmax((q·kᵀ + bias)·scale)·v in f32 by the
    library's backward formula, with one named fault: ``no_di`` drops di
    (``ds = dp·p``), ``ds_unscaled`` leaves ds unscaled, ``no_l`` leaves p
    undivided by l, ``bias_after_scale`` adds the bias after the scale,
    ``bias_transposed`` reads bias[q][k] at [k][q] (K6b's transposed
    scores with the bias read by row for column)."""
    import torch

    if fault == "bias_after_scale":
        bias = bias / scale
    if fault == "bias_transposed":
        bias = bias.transpose(-1, -2)
    s = (torch.einsum("bhqd,bhkd->bhqk", q, k) + bias) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p_true = e / e.sum(-1, keepdim=True)
    p = e if fault == "no_l" else p_true
    o = torch.einsum("bhqk,bhkd->bhqd", p_true, v)
    di = 0.0 if fault == "no_di" else (o * do).sum(-1, keepdim=True)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = (dp - di) * p * (1.0 if fault == "ds_unscaled" else scale)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q),
            torch.einsum("bhqk,bhqd->bhkd", p, do))


def check_flash_bwd(rows: list, shapes=FLASH_BWD_SHAPES) -> None:
    """K6b and K6c: ``torch.autograd.grad`` of ``flash_mha`` in bf16 (K6
    with row stats, di, K6b, K6c) against ``reference_flash_mha_bwd`` in f32
    on the same inputs, each of dq, dk, dv within BWD_TOL of its scale, at
    the training shape (32 sequences of 70 text + 50 region slots, a key
    bias with ~20% of keys masked and the last sequence fully masked), with
    a finite [4, 1, 512, 512] bias of std 4, and at S = 2048; q is drawn so
    the scores have std ≈ 2. Named faults (di dropped, ds unscaled, p not
    divided by l and, at the finite bias, the bias after the scale and the
    bias read transposed) must miss. Then each kernel alone, its plain
    version and SDPA's backward (the whole dq, dk, dv; graph built outside
    the loop) are timed as back-to-back means (:func:`cuda_ms`), and each
    kernel and SDPA's backward also by device time (:func:`device_ms`), and
    SDPA's backward in a CUDA graph (:func:`graph_ms`, device_ms's
    fallback)."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                             flash_mha_bwd_dkv_plain,
                                             flash_mha_bwd_dq,
                                             flash_mha_bwd_dq_plain,
                                             flash_mha_fwd,
                                             reference_flash_mha_bwd)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    for b, h, s_len, bias, *dim in shapes:
        d = dim[0] if dim else 64
        q, k, v, do = (torch.randn(b, h, s_len, d, generator=g, device=dev)
                       for _ in range(4))
        q, k, v, do = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16(), do.bfloat16()
        if bias == "key":
            kb = torch.where(torch.rand(b, 1, 1, s_len, generator=g,
                                        device=dev) > 0.2, 0.0, -10000.0)
            kb[-1] = -10000.0
        else:
            kb = torch.randn(b, 1, s_len, s_len, generator=g, device=dev) * 4
        scale = 1.0 / d ** 0.5
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_mha(*leaves, kb, sm_scale=scale),
                                  leaves, do)
        f32 = [t.float() for t in (q, k, v, do)]
        want = reference_flash_mha_bwd(*f32[:3], kb, f32[3], sm_scale=scale)
        torch.cuda.synchronize()
        tols = [BWD_TOL * max(float(w.abs().max()), 1e-3) for w in want]
        errs = [float((x.float() - w).abs().max()) for x, w in zip(got, want)]
        if not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f"K6b/K6c {b},{h},{s_len}: non-finite gradient")
        faults = ["no_di", "ds_unscaled", "no_l"] + (
            ["bias_after_scale", "bias_transposed"] if bias == "3d" else [])
        fault_miss = {}
        for f in faults:
            fx = flash_bwd_with_fault(*f32[:3], kb, f32[3], scale, f)
            fault_miss[f] = max(float((x - w).abs().max()) / t
                                for x, w, t in zip(fx, want, tols))
        o, m, l = flash_mha_fwd(q, k, v, kb, sm_scale=scale, stats=True)
        di = (o.float() * do.float()).sum(-1).contiguous()
        args = (q, k, v, kb, do, m, l, di)
        sdpa = [t.clone().requires_grad_() for t in (q, k, v)]
        # the graph is built on its own stream, so that device_ms can
        # capture the backward there if the profiler's traces fall short
        sdpa_stream = torch.cuda.Stream()
        sdpa_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(sdpa_stream):
            out = F.scaled_dot_product_attention(
                *sdpa, attn_mask=(kb * scale).bfloat16(), scale=scale)
        torch.cuda.current_stream().wait_stream(sdpa_stream)

        def sdpa_bwd():
            return torch.autograd.grad(out, sdpa, do, retain_graph=True)

        library_ms = cuda_ms(sdpa_bwd)
        library_dev, library_how = device_ms(sdpa_bwd, stream=sdpa_stream)
        # device_ms's fallback, taken every run so that it is known to work
        library_graph = graph_ms(sdpa_bwd, stream=sdpa_stream)
        label = f"q=[{b},{h},{s_len},{d}] bias={list(kb.shape)}"
        sq = b * h * s_len * s_len * d
        in_bytes = nbytes(q, k, v, do, m, l, di, kb)
        whole_ms, whole_by = bound(in_bytes + nbytes(o) + 3 * nbytes(q),
                                   10 * sq, BF16_OPS_S)
        for name, kernel, plain, outs, ops, (lo, hi), match in (
                ("K6b", flash_mha_bwd_dkv, flash_mha_bwd_dkv_plain, 2, 8 * sq, (1, 3),
                 "flash_bwd_dkv"),
                ("K6c", flash_mha_bwd_dq, flash_mha_bwd_dq_plain, 1, 6 * sq, (0, 1),
                 "flash_bwd_dq")):
            ms = cuda_ms(lambda: kernel(*args, sm_scale=scale))
            dev_ms, how = device_ms(lambda: kernel(*args, sm_scale=scale), match)
            plain_ms = cuda_ms(lambda: plain(*args, scale))
            bound_ms, bound_by = bound(in_bytes + outs * nbytes(q), ops, BF16_OPS_S)
            rows.append({"kernel": name, "shape": label,
                         "max_abs_err": max(errs[lo:hi]), "errs": errs[lo:hi],
                         "tols": tols[lo:hi], "ms": ms, "device_ms": dev_ms,
                         "timed_by": how, "plain_ms": plain_ms,
                         "library_ms": library_ms, "library_device_ms": library_dev,
                         "library_timed_by": library_how,
                         "library_graph_ms": library_graph,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "fault_miss": fault_miss, "backward_bound_ms": whole_ms})
        kb_row, kc_row = rows[-2], rows[-1]
        print(f"K6b/K6c {label}: dq/dk/dv err " + "/".join(f"{e:.3e}" for e in errs)
              + " tol " + "/".join(f"{t:.3e}" for t in tols) + "; K6b device_ms="
              f"{kb_row['device_ms']:.4f} ms={kb_row['ms']:.4f} "
              f"plain_ms={kb_row['plain_ms']:.4f} bound_ms={kb_row['bound_ms']:.4f} "
              f"({kb_row['bound_by']}); K6c device_ms={kc_row['device_ms']:.4f} "
              f"ms={kc_row['ms']:.4f} plain_ms={kc_row['plain_ms']:.4f} "
              f"bound_ms={kc_row['bound_ms']:.4f} ({kc_row['bound_by']}); device "
              f"time by {kc_row['timed_by']}; SDPA backward {library_dev:.4f} ms "
              f"by {library_how} ({library_graph:.4f} in a CUDA graph), "
              f"library_ms={library_ms:.4f}; whole-backward bound "
              f"{whole_ms:.4f} ms ({whole_by}); faults miss by "
              + ", ".join(f"{f} {x:.1f}x" for f, x in fault_miss.items()),
              flush=True)
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"K6b/K6c {label}: errors {errs} > {tols}")
        caught = [f for f, x in fault_miss.items() if not x > 1.0]
        if caught:
            raise AssertionError(f"K6b/K6c {label}: the check would pass {caught}")


# Named faults of K1q's packing of the reduction into k32 steps (k = tap ·
# cpg + ci; cpg 8 packs four taps a step, 16 two, 32 one, 64 half of one;
# the last step's tail is zero weights), as plain emulations on the same int8
# inputs: ``dropped_tap_tail``, the last k32 step left out (tap 8, or its
# second half at cpg 64: a loop one step short, or a tail mask that drops
# data); ``stride2_column_order``, at stride 2 the centre tap (kx = 1, the
# patch's odd columns) read one even/odd pair early (input column 2·ox − 2
# in place of 2·ox, zero past the edge).
K1Q_FAULTS = ("dropped_tap_tail", "stride2_column_order")


def k1q_last_step(cpg: int) -> int:
    """The first row k of K1q's last k32 step of the 9·cpg rows."""
    return 32 * ((9 * cpg + 31) // 32 - 1)


def k1q_with_fault(xq, wq, m, bias, groups: int, stride: int, fault: str):
    """K1q's plain version in f32 (exact integer sums, ``y·m + bias``,
    ReLU) with one of ``K1Q_FAULTS``."""
    import torch
    import torch.nn.functional as F

    cpg, c = wq.shape[2], wq.shape[3]

    def conv(xx, ww):
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(xx.permute(0, 3, 1, 2).double(),
                            ww.permute(3, 2, 0, 1).double(), stride=stride,
                            padding=1, groups=groups)

    if fault == "dropped_tap_tail":
        flat = wq.reshape(9 * cpg, c).clone()
        flat[k1q_last_step(cpg):] = 0
        y = conv(xq, flat.reshape(wq.shape))
    elif fault == "stride2_column_order":
        if stride != 2:
            raise ValueError("stride2_column_order is a fault of stride 2")
        centre = torch.zeros_like(wq)
        centre[:, 1] = wq[:, 1]
        shifted = F.pad(xq, (0, 0, 2, 0))[:, :, :xq.shape[2]]
        y = conv(xq, wq - centre) + conv(shifted, centre)
    else:
        raise ValueError(f"unknown K1q fault {fault!r}")
    y = y.permute(0, 2, 3, 1).float() * m.float() + bias.float()
    return torch.relu(y)


def k1q_inputs(n: int, h: int, w: int, c: int, g):
    """K1q's inputs at one shape, 32 groups, drawn from generator ``g`` on
    its device: a ReLU'd bf16 map (the bf16 K1 takes the same), f32 weights
    whose channels' ranges spread 8× (the BN scale evens their outputs out
    again, as a trained BN does), the BN affine."""
    import torch

    dev = g.device
    cpg = c // 32
    x = torch.relu(torch.randn(n, h, w, c, generator=g, device=dev)).bfloat16()
    spread = torch.exp2(torch.rand(c, generator=g, device=dev) * 3)
    wt = torch.randn(3, 3, cpg, c, generator=g, device=dev) * 0.05 * spread
    bn_s = (torch.rand(c, generator=g, device=dev) + 0.5) / spread
    bn_b = torch.randn(c, generator=g, device=dev) * 0.1
    return x, wt, bn_s, bn_b


def check_k1q(rows: list) -> None:
    """K1q at K1's seven X152 shapes, on the path its dispatch rule names
    (the int8 tensor-core kernel at every one), and at ``K1_SIMT_SHAPE``
    (cpg 4: the ``__dp4a`` kernel), on int8 inputs quantized from
    ``k1q_inputs``: bit for bit against its plain version in bf16
    (``torch.equal``: exact sums, the same two roundings), within TOL of
    it in f32, with named faults that must miss (the activation scale
    dropped from the dequant, weight scales per tensor instead of per
    channel, and ``K1Q_FAULTS``). Device time beside K1's in bf16 on the
    same map and weights."""
    import torch

    from cpt_tpu_torch.ops import quant
    from cpt_tpu_torch.ops.grouped_conv import (conv_path, grouped_conv3x3,
                                                grouped_conv3x3_int8,
                                                reference_grouped_conv3x3_int8)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    groups = 32
    for n, h, w, c, stride in K1_SHAPES + [K1_SIMT_SHAPE]:
        cpg = c // groups
        x, wt, bn_s, bn_b = k1q_inputs(n, h, w, c, g)
        qx, qw = quant.quant_act(x), quant.quant_weight(wt, (0, 1, 2))
        qt = quant.quant_weight(wt, (0, 1, 2, 3))
        m = qx.scale * qw.scale * bn_s

        def plain(wq, mm, dtype=torch.float32):
            return lambda: reference_grouped_conv3x3_int8(
                qx.data, wq, mm, bn_b, groups, stride, True, dtype)

        def kernel():
            return grouped_conv3x3_int8(qx.data, qw.data, m, bn_b, groups,
                                        stride, True)

        faults = {"no_act_scale": plain(qw.data, qw.scale * bn_s),
                  "per_tensor_w_scale": plain(qt.data, qx.scale
                                              * qt.scale.expand(c) * bn_s)}
        faults.update({f: (lambda f=f: k1q_with_fault(
            qx.data, qw.data, m, bn_b, groups, stride, f))
            for f in K1Q_FAULTS if stride == 2 or f != "stride2_column_order"})
        path = conv_path(c, cpg)
        out_px = n * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
        compare("K1q", f"x=[{n},{h},{w},{c}] cpg={cpg} stride={stride} "
                f"path={path}", kernel, plain(qw.data, m, torch.bfloat16),
                plain(qw.data, m), rows, faults,
                work=(nbytes(qx.data, qw.data, m, bn_b) + out_px * c * 2,
                      2 * out_px * c * 9 * cpg, INT8_OPS_S),
                device="grouped_conv3x3_int8")
        got, want = kernel(), plain(qw.data, m, torch.bfloat16)()
        exact = bool(torch.equal(got, want))
        w16 = wt.bfloat16()
        k1_ms, _ = device_ms(lambda: grouped_conv3x3(x, w16, bn_s, bn_b, groups,
                                                     stride, True),
                             "grouped_conv3x3")
        rows[-1].update(path=path, exact=exact, k1_bf16_device_ms=k1_ms)
        print(f"  bit for bit against the plain version in bf16: {exact}; K1 "
              f"in bf16 on the same map: device {k1_ms:.4f} ms", flush=True)
        if not exact:
            diff = int((got.float() != want.float()).sum())
            raise AssertionError(f"K1q x=[{n},{h},{w},{c}] stride={stride}: "
                                 f"{diff} outputs differ from the plain version")
        del x, wt, qx, qw, qt, got, want
        torch.cuda.empty_cache()


K7_FAULTS = ("per_tensor_scale", "per_row_weight_scale", "no_residual",
             "block_local_h_scale")
K7_BLOCK = 128   # the rows and columns of h one block of K7's first product writes


# A small shape (M, H, F, tm) at which ``k7_inputs`` shows every K7 fault:
# 2 tiles of 2 row blocks × 8 column blocks, a cluster of 2 on the card.
K7_FAULT_SHAPE = (512, 256, 1024, 256)


def k7_inputs(m: int, h: int, f: int, seed: int) -> list:
    """K7's fault inputs as numpy f32 arrays (x, w1, w2, b1, b2, gamma,
    beta): x's first and second halves of rows at std 0.5 and 4.0, weight
    columns whose ranges spread 8×, nonzero biases and LayerNorm
    parameters."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, h) * np.repeat([0.5, 4.0], m // 2)[:, None]
    w1 = rng.randn(h, f) * 0.05 * np.exp2(rng.uniform(0, 3, f))
    w2 = rng.randn(f, h) * 0.05 * np.exp2(rng.uniform(0, 3, h))
    vecs = [rng.randn(f) * 0.1, rng.randn(h) * 0.1, rng.rand(h) + 0.5,
            rng.randn(h) * 0.1]
    return [a.astype(np.float32) for a in (x, w1, w2, *vecs)]


def ffn_int8_with_fault(x, w1, b1, w2, b2, gamma, beta, tm, fault=None):
    """K7's function in f32 from the f32 weights (dequantized int8 values;
    float64 products), with one named fault (``K7_FAULTS``):
    ``per_tensor_scale`` (one x and one h scale for all of M),
    ``per_row_weight_scale`` (the weights quantized per row, not per
    column), ``no_residual``, or ``block_local_h_scale`` (h quantized by
    the maximum of the 128 × 128 block that wrote it, not of its [tm, F]
    tile: a maximum that was not combined across the tile's blocks)."""
    import torch

    from cpt_tpu_torch.ops import quant

    m, h = x.shape
    t = m if fault == "per_tensor_scale" else tm
    rows = fault == "per_row_weight_scale"

    def dequant_w(w):
        q = quant.quant_weight(w, (1,) if rows else (0,))
        return q.data.double() * (q.scale[:, None] if rows else q.scale).double()

    def dequant_tiles(v):
        return torch.stack([q.data.double() * q.scale.double()
                            for q in map(quant.quant_act, v)])

    def dequant_blocks(v):
        b = K7_BLOCK
        blocks = v.reshape(-1, b, v.shape[-1] // b, b).transpose(1, 2)
        q = quant._tile_quant(blocks.reshape(-1, b, b))
        return (q.data.double() * q.scale.double()).reshape(
            blocks.shape).transpose(1, 2).reshape(v.shape)

    xf = x.float().reshape(m // t, t, h)
    hid = quant.gelu_poly((dequant_tiles(xf) @ dequant_w(w1)).float() + b1)
    hd = dequant_blocks(hid) if fault == "block_local_h_scale" else dequant_tiles(hid)
    y = (hd @ dequant_w(w2)).float() + b2
    if fault != "no_residual":
        y = y + xf
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    return ((y - mu) * torch.rsqrt(var + 1e-12) * gamma + beta).reshape(m, h)


def xla_int8_ffn(x, q1, b1, q2, b2, gamma, beta):
    """The yardstick: ``bench_int8.py``'s ``xla_int8`` composition (per-tensor
    activation scales, exact-erf gelu, ``E[y²]−μ²`` LayerNorm) as two
    ``torch._int_mm`` calls with PyTorch ops between them."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.ops.quant import int8_matmul, quant_act

    inter = int8_matmul(quant_act(x), q1, b1, torch.float32)
    inter = F.gelu(inter).bfloat16()
    y = int8_matmul(quant_act(inter), q2, b2, torch.float32) + x.float()
    mu = y.mean(-1, keepdim=True)
    var = (y * y).mean(-1, keepdim=True) - mu * mu
    return ((y - mu) * torch.rsqrt(var + 1e-12) * gamma + beta).bfloat16()


def check_k7(rows: list) -> None:
    """K7 at the study's shape (M 16384 = 128 sequences × 128 tokens, tm
    1024, 768 → 3072 → 768), first on inputs drawn as the study draws them
    (x ~ N(0, 0.5²) in bf16, weights ~ N(0, 0.02²), zero biases, γ 1, β 0):
    against its plain version, by device time (all of its launches), with
    K4 and the yardstick timed at the same shape by device time too. Then on
    inputs whose tiles' ranges differ 8× (0.5 and 4.0) and whose weight
    columns' ranges spread 8×, with nonzero biases: against the plain
    version, and ``K7_FAULTS`` must miss."""
    import torch

    from cpt_tpu_torch.ops import quant
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    m, h, f, tm = 16384, 768, 3072, 1024

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    for inputs in ("study", "faults"):
        if inputs == "study":
            x = r(m, h, scale=0.5).bfloat16()
            w1, w2 = r(h, f, scale=0.02), r(f, h, scale=0.02)
            b1, b2 = torch.zeros(f, device=dev), torch.zeros(h, device=dev)
            gamma, beta = torch.ones(h, device=dev), torch.zeros(h, device=dev)
        else:
            tiles = torch.tensor([0.5, 4.0], device=dev).repeat(m // tm // 2)
            x = (r(m, h) * tiles.repeat_interleave(tm)[:, None]).bfloat16()
            spread = torch.exp2(torch.rand(f + h, generator=g, device=dev) * 3)
            w1, w2 = r(h, f, scale=0.02) * spread[:f], r(f, h, scale=0.02) * spread[f:]
            b1, b2 = r(f, scale=0.1), r(h, scale=0.1)
            gamma = torch.rand(h, generator=g, device=dev) + 0.5
            beta = r(h, scale=0.1)
        q1, q2 = quant.quant_ffn_weights(w1), quant.quant_ffn_weights(w2)
        args = (x, q1.data, q1.scale, b1, q2.data, q2.scale, b2, gamma, beta)
        faults = None
        if inputs == "faults":
            faults = {fault: (lambda fault=fault: ffn_int8_with_fault(
                x, w1, b1, w2, b2, gamma, beta, tm, fault)) for fault in K7_FAULTS}
        compare("K7", f"x=[{m},{h}] F={f} tm={tm} ({inputs} inputs)",
                lambda: quant.ffn_int8(*args, tm),
                lambda: quant.reference_ffn_int8(*args, tm),
                lambda: quant.reference_ffn_int8(x.float(), *args[1:], tm),
                rows, faults,
                work=(nbytes(*args) + nbytes(x), 4 * m * h * f, INT8_OPS_S),
                device="ffn_int8_")
        if inputs != "study":
            continue
        w1h, w2h = w1.bfloat16(), w2.bfloat16()
        cm = [quant.QuantTensor(q.data.t().contiguous().t(), q.scale)
              for q in (q1, q2)]                 # _int_mm's column-major B
        extra = {"k4_device_ms": device_ms(lambda: fused_ffn(
                     x, w1h, b1, w2h, b2, gamma, beta))[0],
                 "yardstick_device_ms": device_ms(lambda: xla_int8_ffn(
                     x, cm[0], b1, cm[1], b2, gamma, beta))[0],
                 "k4_bound_ms": bound(nbytes(x, w1h, w2h, b1, b2, gamma, beta)
                                      + nbytes(x), 4 * m * h * f, BF16_OPS_S)[0]}
        rows[-1].update(extra)
        print(f"  at this shape: K4 (bf16) device {extra['k4_device_ms']:.4f} ms "
              f"(bound {extra['k4_bound_ms']:.4f}); xla_int8 yardstick (two "
              f"torch._int_mm) device {extra['yardstick_device_ms']:.4f} ms",
              flush=True)


def run_ffn_study(counters) -> dict:
    """Phase 6, K7's path: ``bench_int8.py``'s ``ffn_pallas`` study on the
    card. Its inputs (numpy seed 0: x ~ N(0, 0.5²) [16384, 768] in bf16,
    w1, w2 ~ N(0, 0.02²), zero biases, γ 1, β 0), its weights quantized as
    its ``qw`` does, one forward of K7 at tm 1024 (counted), and its check:
    the cosine of K7's output against K4's (the bf16 fused FFN) on the same
    x and f32 weights."""
    import torch

    from cpt_tpu_torch.ops import quant
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn

    m, h, f = 128 * 128, 768, 3072
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(m, h).astype(np.float32) * 0.5).to(dev).bfloat16()
    w1 = torch.from_numpy(rng.randn(h, f).astype(np.float32) * 0.02).to(dev)
    w2 = torch.from_numpy(rng.randn(f, h).astype(np.float32) * 0.02).to(dev)
    b1, b2 = torch.zeros(f, device=dev), torch.zeros(h, device=dev)
    gamma, beta = torch.ones(h, device=dev), torch.zeros(h, device=dev)
    (w1q, s1), (w2q, s2) = quant.quant_ffn_weights(w1), quant.quant_ffn_weights(w2)
    ref = fused_ffn(x, w1, b1, w2, b2, gamma, beta).float().flatten()
    torch.cuda.synchronize()
    zero_counts(counters)
    got = quant.ffn_int8(x, w1q, s1, b1, w2q, s2, b2, gamma, beta, 1024)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    got = got.float().flatten()
    cos = float(ref @ got / (ref.norm() * got.norm() + 1e-9))
    print(f"K7 study (bench_int8.py ffn_pallas: M {m}, tm 1024): cos vs K4 "
          f"{cos:.6f}; launches {launches}", flush=True)
    if (launches["K7"] != 1 or not torch.isfinite(got).all()
            or got.numel() != m * h or not cos > 0.999):
        raise AssertionError(f"K7 study: launches {launches}, cos {cos}")
    return {"cos_vs_k4": cos, "launches": launches}


def run_int8_extraction(counters) -> dict:
    """Phase 6, the int8 extraction path at full width:
    ``tools/extract_features --synthetic 4 --copies_per_chunk 4`` (VinVL
    X152-C4, random weights from seed 0, 1024×1024 canvases, 3 candidates
    each: 4 chunks of 3 copies and a padding copy) at ``--precision int8``,
    then ``int8:<s>``: K1q 50 launches a chunk (47 body blocks + 3 stage-5
    blocks), K1 none, K2 at least one, finite features. Then the int8 run
    again with its int8 ops swapped for their plain versions (patched here;
    the package has no switch for it): the features within
    INT8_FEATURE_TOL. Then ``--precision bf16`` on the same tasks: its
    copies/s and the cosine between its features and the int8 ones,
    printed, not gated. Last, int8 and bf16 once more under
    ``torch.profiler``: device time per chunk by kernel family."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpt_tpu_torch.ops import grouped_conv, quant
    from cpt_tpu_torch.tools import extract_features, int8_gap

    chunks = 4

    def plain_dense(xq, wq, stride, padding):
        return grouped_conv.exact_conv(xq, wq, stride, padding)

    def extract(root, precision, plain=False, profiled=False):
        path = (f"{root}/{precision.replace(':', '_')}{'_plain' if plain else ''}"
                f"{'_profiled' if profiled else ''}.tsv")
        real = quant.grouped_conv3x3_int8, quant.int_mm_conv
        if plain:
            quant.grouped_conv3x3_int8 = grouped_conv.reference_grouped_conv3x3_int8
            quant.int_mm_conv = plain_dense
        zero_counts(counters)
        prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if profiled else contextlib.nullcontext())
        try:
            with prof:
                info = extract_features.main(["--synthetic", "4", "--copies_per_chunk",
                                              str(chunks), "--precision", precision,
                                              "--output", path])
                torch.cuda.synchronize()
        finally:
            quant.grouped_conv3x3_int8, quant.int_mm_conv = real
        if profiled:
            groups, busy, top = device_groups(prof, chunks, EXTRACT_GROUPS)
            wall = info["seconds"] * 1e3 / chunks
            print(f"--precision {precision} under torch.profiler, per chunk of "
                  f"{chunks} copies: {wall:.2f} ms on the host clock, device "
                  f"kernels {busy:.2f} ms (busy share {busy / wall:.3f}): "
                  + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
                  + "; top: " + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top),
                  flush=True)
            return {"chunk_ms": wall, "device_ms": busy, "groups": groups,
                    "top": top}
        launches = {k: fn.launches for k, fn in counters.items()}
        k1_paths(counters, launches, f"extract_features --precision {precision}")
        if not plain:
            k1_paths(counters, launches,
                     f"extract_features --precision {precision}", "K1q")
        print(f"extract_features --precision {precision}"
              f"{' (int8 ops plain)' if plain else ''}: {info['copies']} copies "
              f"in {info['seconds'] * 1e3:.1f} ms, {info['copies_per_s']:.2f} "
              f"copies/s; launches {launches}", flush=True)
        return {"precision": precision, "copies_per_s": info["copies_per_s"],
                "seconds": info["seconds"], "launches": launches,
                "feats": int8_gap.tsv_features(path)}

    with tempfile.TemporaryDirectory() as root:
        runs = {"int8": extract(root, "int8"),
                "int8_static": extract(root, f"int8:{INT8_STATIC_SCALE}"),
                "int8_plain": extract(root, "int8", plain=True),
                "bf16": extract(root, "bf16")}
        breakdown = {p: extract(root, p, profiled=True) for p in ("int8", "bf16")}
    for name in ("int8", "int8_static"):
        got = runs[name]["launches"]
        if (got["K1q"] != 50 * chunks or got["K1"] != 0 or got["K2"] < 1
                or not np.isfinite(runs[name]["feats"]).all()):
            raise AssertionError(f"{name} extraction: launches {got}")
    feats = runs["int8"]["feats"]
    scale = float(np.abs(feats).max())
    gap = float(np.abs(feats - runs["int8_plain"]["feats"]).max()) / scale
    bf16 = runs["bf16"]["feats"].ravel()
    cos = float(feats.ravel() @ bf16 / (np.linalg.norm(feats) * np.linalg.norm(bf16)))
    print(f"int8 features: {feats.shape[0]} regions; vs the plain int8 ops "
          f"max |Δ| / max |feature| {gap:.4e} (tol {INT8_FEATURE_TOL}); cosine "
          f"vs bf16 {cos:.6f}; copies/s int8 {runs['int8']['copies_per_s']:.2f}, "
          f"int8:{INT8_STATIC_SCALE} {runs['int8_static']['copies_per_s']:.2f}, "
          f"bf16 {runs['bf16']['copies_per_s']:.2f}", flush=True)
    if not gap <= INT8_FEATURE_TOL:
        raise AssertionError(f"int8 features differ from the plain int8 ops: {gap}")
    for r in runs.values():
        del r["feats"]
    runs["int8"].update(plain_gap=gap, cos_vs_bf16=cos)
    runs["extract_breakdown"] = breakdown
    return runs


def build_resident():
    """VinVL X152-C4 + Oscar-base at full width, random weights from seed 0
    in the reference layouts, resident on the card."""
    import torch

    from cpt_tpu_torch.tools import cpt_predict as cp

    t0 = time.perf_counter()
    res = cp.build_resident("cuda", torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"full-width models resident in {setup_s:.1f} s "
          f"(X152-C4 detector, Oscar-base 12x768, vocab "
          f"{res.bert_cfg.vocab_size})", flush=True)
    return res, setup_s


def run_requests(res, counters, idle=("K5", "K6", "K6b", "K6c", "K1q", "K7"),
                 oracle=None, profile=False) -> dict:
    """Full-width grounding requests with given candidates
    (``cpt_predict.predict`` with dets): a warm-up, then 8, 8 and 16
    candidates, each in its own work directory; then (``profile``) one
    more 16-candidate request under ``torch.profiler``; then each request's
    candidate scores (and, given ``oracle``, that resident's scores of the
    same features, and the scores under each of SCORE_FAULTS) and
    scoring-batch count are read back from its interchange files, after the
    launch counts are taken. The kernels in
    ``idle`` must not launch; every other counted kernel must; K1's
    launches must take the path the dispatch rule names."""
    import torch

    from cpt_tpu_torch.data.refcoco import (RefcocoCPTData,
                                            iter_eval_batches,
                                            tsv_region_features)
    from cpt_tpu_torch.tools import cpt_predict as cp

    rng = np.random.RandomState(2024)

    def request(n_dets):
        img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        xy = rng.uniform(0, 400, (n_dets, 2))
        wh = rng.uniform(24, 240, (n_dets, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, [639, 479])], 1)
        return img, np.round(boxes).tolist()

    def answer(img, dets, wd):
        t = time.perf_counter()
        box = cp.predict(res, img, "the person on the left", dets, workdir=wd)
        torch.cuda.synchronize()
        return box, time.perf_counter() - t

    def scoring_batches(wd):
        data = RefcocoCPTData(f"{wd}/predictions.tsv", f"{wd}/ann.json",
                              f"{wd}/stage2_det.json", res.tokenizer,
                              img_feat_dim=res.bert_cfg.img_feature_dim)
        n = sum(1 for _ in iter_eval_batches(data, cp.SCORE_BATCH))
        data.tsv.close()
        return n

    with tempfile.TemporaryDirectory() as root:
        _, cold_s = answer(*request(8), f"{root}/warmup")
        print(f"warm-up request (8 candidates, attention_impl="
              f"{res.bert_cfg.attention_impl!r}): {cold_s * 1e3:.1f} ms",
              flush=True)
        zero_counts(counters)
        reqs = []
        for n_dets in (8, 8, 16):
            img, dets = request(n_dets)
            wd = f"{root}/request{len(reqs)}"
            box, sec = answer(img, dets, wd)
            feats = tsv_region_features(f"{wd}/predictions.tsv")
            if box not in dets:
                raise AssertionError(f"predicted {box} is not a candidate")
            if feats.shape != (n_dets, n_dets, 2054) or not np.isfinite(feats).all():
                raise AssertionError(f"bad features {feats.shape}")
            reqs.append({"candidates": n_dets, "ms": sec * 1e3, "box": box,
                         "dets": dets, "workdir": wd})
            print(f"request {len(reqs)} ({n_dets} candidates, 480x640 image, "
                  f"640x1024 canvas): {sec * 1e3:.1f} ms", flush=True)
        launches = {k: fn.launches for k, fn in counters.items()}
        paths = k1_paths(counters, launches, "grounding requests")
        breakdown = None
        if profile:
            img, dets = request(16)
            before = {k: counters[k].launches for k in ("K3", "K4")}
            breakdown = profiled(lambda: answer(img, dets, f"{root}/profiled"),
                                 "grounding request (16 candidates)")
            check_gemm_group(breakdown["groups"], {
                k: counters[k].launches - n for k, n in before.items()},
                "the profiled grounding request")
        for r in reqs:
            wd = r.pop("workdir")
            r["scores"] = cp.candidate_scores(res, wd)
            if oracle is not None:
                r["scores_f32"] = cp.candidate_scores(oracle, wd)
                r["scores_faults"] = {name: fault_scores(res, wd, fault)
                                      for name, fault in SCORE_FAULTS.items()}
            r["scoring_batches"] = scoring_batches(wd)
    total = sum(r["ms"] for r in reqs) / 1e3
    copies = sum(r["candidates"] for r in reqs)
    print(f"copies/s over the 3 requests: {copies / total:.2f}; launches "
          f"{launches}; K1 by path {paths}", flush=True)
    missing = [k for k, n in launches.items() if n <= 0 and k not in idle]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    busy = [k for k in idle if launches[k] != 0]
    if busy:
        raise AssertionError(f"kernels {busy} launched off their path: "
                             f"{launches}")
    return {"warmup_ms": cold_s * 1e3, "requests": reqs,
            "copies_per_s": copies / total, "launches": launches,
            "k1_paths": paths, "profile": breakdown}


def rebuilt_scorer(res, dtype, **config_changes):
    """``res`` with its detector shared and its Oscar-base rebuilt with
    ``config_changes`` in ``dtype``, loaded with the weights ``res``
    computes with: its matrices and tables rounded to its compute dtype
    (the vectors, biases and LayerNorm parameters, stay f32: K3 and K4 and
    every LayerNorm read them so), so an f32 rebuild is the f32 path on the
    bf16 model's weights (the flash resident is what
    ``cpt_predict.build_resident(..., attention_impl="flash")`` builds)."""
    import torch

    from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT

    out = copy.copy(res)
    out.bert_cfg = dataclasses.replace(res.bert_cfg, **config_changes)
    with torch.device(res.device):
        out.oscar = REC_MLM_CPT(out.bert_cfg, dtype).eval()
    out.oscar.load_state_dict({
        k: v.to(res.oscar.dtype).float() if v.dim() > 1 else v
        for k, v in res.oscar.state_dict().items()})
    return out


# Named faults of the flash scoring path, each a wrapper of ``flash_mha``
# as ``models/bert/model.py`` calls it: the key mask dropped, and the
# 1/sqrt(d) scale dropped. Scored after the launch counts are read.
SCORE_FAULTS = {
    "mask_dropped": lambda f: lambda q, k, v, bias, sm_scale: f(
        q, k, v, None, sm_scale=sm_scale),
    "scale_dropped": lambda f: lambda q, k, v, bias, sm_scale: f(
        q, k, v, bias, sm_scale=1.0)}


def fault_scores(res, workdir: str, fault) -> list:
    """``res``'s candidate scores of the request in ``workdir`` with its
    attention's ``flash_mha`` replaced by ``fault(flash_mha)``."""
    from cpt_tpu_torch.models.bert import model
    from cpt_tpu_torch.tools import cpt_predict as cp

    real = model.flash_mha
    model.flash_mha = fault(real)
    try:
        return cp.candidate_scores(res, workdir)
    finally:
        model.flash_mha = real


def check_flash_requests(auto: dict, flash: dict) -> None:
    """The flash path answers each request as the "auto" path does: K6
    launched 12 times (one a layer) for each scoring batch, K4 as often, K3
    never; each of the flash-vs-"auto", flash-vs-f32 and "auto"-vs-f32 gaps
    of the candidate scores (the f32 einsum path on the same features)
    within SCORE_TOL, and the flash path with each of SCORE_FAULTS farther
    than that from the f32 path; the same box, unless the "auto" path's own
    top two scores are within SCORE_TOL of each other (a tie at bf16
    resolution), where the flash path's pick must score within it of the
    top."""
    n_layers = 12
    batches = sum(r["scoring_batches"] for r in flash["requests"])
    want = {"K6": n_layers * batches, "K4": n_layers * batches, "K3": 0}
    got = {k: flash["launches"][k] for k in want}
    print(f"flash requests: {batches} scoring batches, launches {got} "
          f"(want {want})", flush=True)
    if got != want:
        raise AssertionError(f"flash path launches {got}, want {want}")
    tol = SCORE_TOL
    for i, (a, f) in enumerate(zip(auto["requests"], flash["requests"])):
        sa, sf, s32 = (np.asarray(x) for x in (a["scores"], f["scores"],
                                               f["scores_f32"]))
        errs = {"flash-auto": float(np.abs(sf - sa).max()),
                "flash-f32": float(np.abs(sf - s32).max()),
                "auto-f32": float(np.abs(sa - s32).max())}
        fault_errs = {k: float(np.abs(np.asarray(v) - s32).max())
                      for k, v in f["scores_faults"].items()}
        gap = float(np.diff(np.sort(sa)[-2:])[0])
        tie = gap <= tol
        f.update(score_errs=errs, score_fault_errs=fault_errs, score_tol=tol,
                 auto_top2_gap=gap)
        print(f"flash request {i + 1}: box {f['box']} (auto {a['box']}; auto "
              f"top-2 gap {gap:.3e}{', a tie' if tie else ''}); max |score "
              f"diff| " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
              + f" (tol {tol:.3e}, max score {np.abs(sa).max():.4f}); faults "
              + ", ".join(f"{k} {e:.3e} ({e / tol:.1f}x tol)"
                          for k, e in fault_errs.items()), flush=True)
        # scores follow the candidates' order (copy i paints candidate i)
        same_box = same_pick(f["box"], a["box"], list(sa), f["dets"])
        if not same_box or not max(errs.values()) <= tol:
            raise AssertionError(f"flash request {i + 1} differs from auto")
        caught = [k for k, e in fault_errs.items() if not e > tol]
        if caught:
            raise AssertionError(f"flash request {i + 1}: the score check "
                                 f"would pass {caught}")


def run_long_context(flash_res, oracle, auto_res) -> dict:
    """One full-width ``BertImgModel`` forward under ``"flash"`` and one
    under ``"auto"`` (the fused blocks; K3's core at S = 1020, which it
    once refused): batch 4, 70 text tokens + 950 regions (S = 1020), some
    keys masked, each against the einsum path in f32 (``oracle``'s) on the
    same weights. K6 launches once a layer under "flash", K3 once a layer
    under "auto"."""
    import torch

    from cpt_tpu_torch.ops.attention import flash_mha
    from cpt_tpu_torch.ops.fused_attention import fused_attention_block

    cfg = flash_res.bert_cfg
    rng = np.random.RandomState(31)
    b, t, r = 4, 70, 950
    ids = rng.randint(1000, cfg.vocab_size, (b, t))
    ids[:, 0] = 101
    mask = np.zeros((b, t + r), np.int64)
    for i, (nt, nr) in enumerate([(70, 950), (40, 900), (25, 600), (12, 300)]):
        mask[i, :nt] = 1
        mask[i, t:t + nr] = 1
    feats = (rng.rand(b, r, cfg.img_feature_dim) * 2).astype(np.float32)
    dev = torch.device("cuda")
    ids_t, mask_t = (torch.from_numpy(a).to(dev) for a in (ids, mask))
    feats_t = torch.from_numpy(feats).to(dev)
    seg = torch.zeros_like(ids_t)

    def forward(model):
        t0 = time.perf_counter()
        out, _ = model(ids_t, seg, mask_t, img_feats=feats_t)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    out = {}
    with torch.inference_mode():
        want, ref_ms = forward(oracle.oscar.bert)
        want, ref_ms = forward(oracle.oscar.bert)
        for impl, res, kernel in (("flash", flash_res, flash_mha),
                                  ("auto", auto_res, fused_attention_block)):
            forward(res.oscar.bert)
            before = kernel.launches
            got, ms = forward(res.oscar.bert)
            launches = kernel.launches - before
            got = got.float()
            if not torch.isfinite(got).all() or got.shape != (b, t + r, 768):
                raise AssertionError(f"long-context {impl} output "
                                     f"{tuple(got.shape)} or non-finite")
            err = float((got - want.float()).abs().max())
            tol = LONG_TOL * float(want.float().abs().max())
            name = "K6" if impl == "flash" else "K3"
            print(f"long-context forward (batch 4, 70 text + 950 regions, "
                  f"12x768, {impl}, bf16): {ms:.2f} ms, {name} launches "
                  f"{launches}; einsum f32 {ref_ms:.2f} ms; max_abs_err "
                  f"{err:.3e} (tol {tol:.3e})", flush=True)
            if launches != cfg.num_hidden_layers or not err <= tol:
                raise AssertionError(f"long-context {impl} forward: {name} "
                                     f"launches {launches}, err {err} > {tol}")
            out[impl] = {"ms": ms, "max_abs_err": err, "tol": tol,
                         "launches": launches}
    out["einsum_f32_ms"] = ref_ms
    return out


# phase 4's --detect requests: each grounds ~100 candidates (5-12 s on the
# card's host), so one, cold: a warm-up request read no faster than the
# first request after it
DETECT_REQUESTS = 1


def run_detect_requests(res, counters) -> dict:
    """Full-width ``--detect`` requests (DETECT_REQUESTS): ``cpt_predict.
    predict`` without dets, so the detector proposes the candidates (RPN →
    K5 → box head on K2/K1 → ``NMS_FILTER`` 2 on K5 → ``conf`` 0), then
    grounds them. The detect step is timed and its launches counted by
    wrapping ``Resident.detect``."""
    import torch

    from cpt_tpu_torch.data.refcoco import tsv_region_features
    from cpt_tpu_torch.tools import cpt_predict as cp

    rng = np.random.RandomState(2025)
    step: dict = {}
    detect = res.detect

    def timed_detect(image, conf):
        before = {k: fn.launches for k, fn in counters.items()}
        t = time.perf_counter()
        out = detect(image, conf)
        step["ms"] = (time.perf_counter() - t) * 1e3
        step["candidates"] = [[float(v) for v in b] for b in out[0]]
        step["launches"] = {k: fn.launches - before[k]
                            for k, fn in counters.items()}
        return out

    res.detect = timed_detect

    def answer(img, wd):
        t = time.perf_counter()
        box = cp.predict(res, img, "the person on the left", None,
                         workdir=wd, conf=0.0)
        torch.cuda.synchronize()
        return box, time.perf_counter() - t

    def image():
        return rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)

    try:
        with tempfile.TemporaryDirectory() as wd:
            zero_counts(counters)
            reqs = []
            for _ in range(DETECT_REQUESTS):
                before = {k: fn.launches for k, fn in counters.items()}
                box, sec = answer(image(), wd)
                n_k5 = counters["K5"].launches - before["K5"]
                feats = tsv_region_features(f"{wd}/predictions.tsv")
                n_cand = len(step["candidates"])
                if box not in step["candidates"]:
                    raise AssertionError(f"predicted {box} is not a detected "
                                         f"candidate")
                if (n_cand < 2 or feats.shape != (n_cand, n_cand, 2054)
                        or not np.isfinite(feats).all()):
                    raise AssertionError(f"{n_cand} candidates, features "
                                         f"{feats.shape}")
                det_l = step["launches"]
                if n_k5 < 2 or det_l["K1"] <= 0 or det_l["K2"] <= 0:
                    raise AssertionError(f"detect step launches {det_l}, K5 "
                                         f"{n_k5} in the request")
                reqs.append({"candidates": n_cand, "ms": sec * 1e3,
                             "detect_ms": step["ms"],
                             "ground_ms": sec * 1e3 - step["ms"],
                             "detect_launches": det_l, "k5_launches": n_k5,
                             "box": box})
                print(f"detect request {len(reqs)} (480x640 image, 1024x1024 "
                      f"detect canvas, conf 0; cold): {sec * 1e3:.1f} ms = detect "
                      f"{step['ms']:.1f} + ground {sec * 1e3 - step['ms']:.1f}"
                      f"; {n_cand} candidates; detect-step launches K1 "
                      f"{det_l['K1']} K2 {det_l['K2']} K5 {det_l['K5']}",
                      flush=True)
            launches = {k: fn.launches for k, fn in counters.items()}
            paths = k1_paths(counters, launches, "detect requests")
            img = image()
            breakdown = profiled(lambda: detect(img, 0.0), "detect step")
    finally:
        res.detect = detect
    print(f"launches over the {len(reqs)} detect requests: {launches}; K1 by path "
          f"{paths}", flush=True)
    idle = ("K6", "K6b", "K6c", "K1q", "K7")
    missing = [k for k, n in launches.items() if n <= 0 and k not in idle]
    if missing or any(launches[k] for k in idle):
        raise AssertionError(f"kernels not launched on the detect path: "
                             f"{missing}, or {idle} launched: {launches}")
    return {"requests": reqs, "launches": launches,
            "k1_paths": paths, "profile": breakdown}


CAPTIONS = ("the person on the left", "a dog near the car", "the red chair",
            "man holding an umbrella")


def training_data(res, root: str, n_queries: int = 16, n_cands: int = 4):
    """Stage-1 features of ``n_queries`` grounding queries (a 480x640 image
    and ``n_cands`` candidate boxes each; the gt box is candidate
    ``i % n_cands``), extracted by the resident detector into
    ``predictions.tsv`` with its ann and od-label jsons → (RefcocoCPTData,
    their paths, extraction seconds)."""
    import torch

    from cpt_tpu_torch.data.refcoco import RefcocoCPTData, det_json_for_stage2
    from cpt_tpu_torch.engine.extract import refcoco_task

    rng = np.random.RandomState(2026)
    tasks, anns = [], []
    for i in range(n_queries):
        img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
        xy = rng.uniform(0, 400, (n_cands, 2))
        wh = rng.uniform(24, 240, (n_cands, 2))
        boxes = np.round(np.concatenate([xy, np.minimum(xy + wh, [639, 479])], 1))
        x1, y1, x2, y2 = boxes[i % n_cands].tolist()
        caption = CAPTIONS[i % len(CAPTIONS)]
        tasks.append(refcoco_task(f"q{i}", img, img.shape[:2], boxes, caption))
        anns.append({"id": f"q{i}", "caption": caption, "height": 480,
                     "bbox": [x1, y1, x2 - x1 + 1, y2 - y1 + 1]})
    paths = {k: f"{root}/{v}" for k, v in (("data_file", "predictions.tsv"),
                                           ("ann_file", "ann.json"),
                                           ("det_file", "stage2_det.json"))}
    t0 = time.perf_counter()
    res.extractor.run(tasks, paths["data_file"])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    with open(paths["ann_file"], "w") as f:
        json.dump(anns, f)
    det_json_for_stage2(paths["data_file"], paths["det_file"])
    data = RefcocoCPTData(paths["data_file"], paths["ann_file"],
                          paths["det_file"], res.tokenizer,
                          img_feat_dim=res.bert_cfg.img_feature_dim)
    return data, paths, extract_s


EXTRACT_GROUPS = (("K1q", ("grouped_conv3x3_int8",)),
                  ("K1", ("grouped_conv3x3_mma", "grouped_conv3x3_kernel")),
                  ("K2", ("roi_align",)),
                  ("GEMM / conv (cuBLAS, cuDNN)", ("gemm", "nvjet", "cutlass", "xmma",
                                                   "sm90", "conv", "implicit")),
                  ("elementwise / reduce", ("elementwise", "vectorized", "reduce",
                                           "cat", "pad", "index")))
# A kernel counts in the first family whose patterns it holds, so K6's
# "flash_attention_kernel" comes before K3's "attention_kernel", and the
# shared GEMM's kernels (``csrc/gemm.cu``: "wgmma_bias_act_kernel",
# "wgmma_residual_ln_kernel"; "gemm_bias_act_kernel" and
# "gemm_residual_ln_kernel" in checkouts from before them, which
# ``chip_e2e.py --package`` times) come before cuBLAS's "gemm", and K5's
# kernels ("nms_rank_kernel", "nms_mask_kernel", "nms_scan_kernel";
# "nms_kernel" before them) before the elementwise family's "scan".
GEMM_GROUP = "K3 / K4 GEMM"
REQUEST_GROUPS = (("K1", ("grouped_conv3x3_mma", "grouped_conv3x3_kernel")),
                  ("K2", ("roi_align",)), ("K5", ("nms_",)),
                  ("K6", ("flash_attention_kernel",)),
                  ("K3 core", ("attention_kernel",)),
                  (GEMM_GROUP, ("wgmma_bias_act", "wgmma_residual_ln",
                                "wgmma_residual_stats", "residual_ln_rows",
                                "gemm_bias_act_kernel", "gemm_residual_ln_kernel")),
                  ("GEMM / conv (cuBLAS, cuDNN)", ("gemm", "nvjet", "cutlass", "xmma",
                                                   "sm90", "conv", "implicit",
                                                   "cudnn")),
                  ("elementwise / reduce", ("elementwise", "vectorized", "reduce",
                                           "cat", "pad", "index", "copy", "fill",
                                           "sort", "scan")))
KERNEL_GROUPS = (("K6b", ("flash_bwd_dkv",)), ("K6c", ("flash_bwd_dq",)),
                 ("K6", ("flash_attention_kernel",)),
                 ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "sm90")),
                 ("elementwise / reduce", ("elementwise", "vectorized", "reduce",
                                          "foreach", "multi_tensor")))


def kernel_group(key: str, kernel_groups) -> str:
    """The family of the device kernel named ``key``: the first of
    ``kernel_groups`` ((name, name patterns) pairs) with a pattern in it,
    else "other"."""
    low = key.lower()
    return next((n for n, pats in kernel_groups if any(x in low for x in pats)),
                "other")


def device_groups(prof, reps: int, kernel_groups) -> tuple:
    """A ``torch.profiler`` run's device kernels (copies left out) per
    repetition, summed by family (:func:`kernel_group`) → (ms by family,
    busy ms, the top 8 kernels)."""
    from torch.autograd import DeviceType

    kernels = [(e.key, e.self_device_time_total / 1e3 / reps)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset"))]
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["other"] = 0.0
    for key, ms in kernels:
        groups[kernel_group(key, kernel_groups)] += ms
    return groups, sum(ms for _, ms in kernels), sorted(kernels, key=lambda kv: -kv[1])[:8]


def profiled(fn, label: str) -> dict:
    """``fn()`` once under ``torch.profiler`` (it ends in a synchronise):
    host ms, device kernel ms by family (REQUEST_GROUPS), busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    groups, busy, top = device_groups(prof, 1, REQUEST_GROUPS)
    print(f"{label} under torch.profiler: {wall:.2f} ms on the host clock, "
          f"device kernels {busy:.2f} ms (busy share {busy / wall:.3f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
          + "; top: " + "; ".join(f"{k[:50]} {v:.3f}" for k, v in top),
          flush=True)
    return {"ms": wall, "device_ms": busy, "groups": groups, "top": top}


def check_gemm_group(groups: dict, ran: dict, where: str) -> None:
    """Raise unless a profile's "K3 / K4 GEMM" group (and, where K3 ran,
    its "K3 core" group) holds device time when the launch counters ``ran``
    say that K3 or K4 launched: a kernel renamed out of its group would
    otherwise leave the breakdown silently wrong."""
    if (ran["K3"] or ran["K4"]) and not groups[GEMM_GROUP] > 0:
        raise AssertionError(f"{where}: K3/K4 launched {ran} but the profile's "
                             f"{GEMM_GROUP!r} group is empty: {groups}")
    if ran["K3"] and not groups["K3 core"] > 0:
        raise AssertionError(f"{where}: K3 launched {ran['K3']} times but the "
                             f"profile's 'K3 core' group is empty: {groups}")


def profile_train_step(model, batch, dev, reps: int = 3) -> dict:
    """Where a prompt-tuning step's time goes: ``reps`` steps timed on the
    host clock (the optimizer's update timed alone, between two
    synchronisations), then ``reps`` steps under ``torch.profiler`` (device
    kernels only) grouped by kernel family."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpt_tpu_torch.engine import train as train_lib

    tx = train_lib.build_optimizer(model, train_lib.OptimConfig(warmup_steps=0))
    state = train_lib.create_train_state(model, tx)
    step = train_lib.make_mlm_train_step(model, tx)
    gen = torch.Generator(device=dev).manual_seed(1)
    real, opt_ms = tx.update, []

    def timed_update(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real(*a)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t) * 1e3)

    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    tx.update = timed_update
    for _ in range(reps):
        step(state, batch, gen)
    tx.update = real
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch, gen)
        torch.cuda.synchronize()
    groups, busy, top = device_groups(prof, reps, KERNEL_GROUPS)
    print(f"phase 5 step breakdown (batch of {batch[0].shape[0]}, flash, bf16): "
          f"{step_ms:.2f} ms/step on the host clock; optimizer update alone "
          f"{np.mean(opt_ms):.2f} ms; device kernels {busy:.2f} ms/step (busy "
          f"share {busy / step_ms:.3f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in groups.items())
          + "; top kernels: " + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top),
          flush=True)
    return {"step_ms": step_ms, "optimizer_ms": float(np.mean(opt_ms)),
            "device_ms": busy, "groups": groups, "top": top}


# phase 5's prompt-tuning steps (epochs of the 16 queries' 32 sampled
# copies: one step each), cut from the tool's default 20 for time
TRAIN_STEPS = 10
# the training runs of phases 9-11 (VCR and GQA prompt tuning, the REC,
# GQA and VCR full-finetune baselines): a first step and one steady one,
# what their checks read (every step's launches, finite losses, the steady
# steps' time); GQA's take two calls a step (grad_accum_steps 2)
TUNING_STEPS = 2


def run_training(res, counters) -> dict:
    """Phase 5. Prompt tuning through ``refcoco_cpt.train`` (the tool's
    defaults: batch 32, AdamW lr 2.5e-5, weight decay 0.05, warmup 10%;
    TRAIN_STEPS epochs of the 16 queries' 32 sampled copies, a step each) of
    Oscar-base under "flash" with attention dropout 0 in bf16, counting
    each step's launches and profiling a step; then, on the same initial
    weights and ``grad_gap``'s synthetic batches (those the tolerances were
    derived on), one step's gradients and 10 deterministic steps' losses
    against the einsum path in f32 (with K6b's dK zeroed as the fault the
    gradient check must catch); then 3 deterministic steps under "auto"."""
    import torch

    from cpt_tpu_torch.data.refcoco import iter_train_batches
    from cpt_tpu_torch.engine import train as train_lib
    from cpt_tpu_torch.ops import fused_attention, fused_ffn
    from cpt_tpu_torch.tools import grad_gap, refcoco_cpt

    dev, cfg = res.device, res.bert_cfg
    init = {k: v.clone() for k, v in res.oscar.state_dict().items()}
    with tempfile.TemporaryDirectory() as root:
        data, paths, extract_s = training_data(res, root)
        print(f"phase 5: stage-1 features of {len(data)} queries extracted in "
              f"{extract_s * 1e3:.1f} ms", flush=True)
        args = refcoco_cpt.build_args().parse_args(
            ["--train_data_file", paths["data_file"], "--num_train_epochs",
             str(TRAIN_STEPS)]
            + [x for k, v in paths.items() for x in (f"--{k}", v)])
        model = grad_gap.build(init, cfg, torch.bfloat16, dev, **grad_gap.FLASH)
        steps = []
        mark = [time.perf_counter(), {k: 0 for k in counters}]

        def on_step(step, loss):
            now = time.perf_counter()
            seen = {k: fn.launches for k, fn in counters.items()}
            steps.append({"step": step, "loss": loss, "ms": (now - mark[0]) * 1e3,
                          "launches": {k: seen[k] - mark[1][k] for k in seen}})
            mark[:] = [now, seen]

        zero_counts(counters)
        t0 = mark[0] = time.perf_counter()
        losses = refcoco_cpt.train(model, data, args, dev, on_step)
        train_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        batches = [train_lib.batch_arrays_mlm(
            next(iter_train_batches(data, args.per_gpu_train_batch_size, seed)), dev)
            for seed in (0, 1)]
        data.tsv.close()
    n_seq = args.per_gpu_train_batch_size
    steady = [st["ms"] for st in steps[1:]]
    print(f"phase 5: {len(losses)} steps of batch {n_seq} (flash, bf16) in "
          f"{train_s:.2f} s; ms/step {np.mean(steady):.2f} after the first "
          f"({steps[0]['ms']:.1f}); {n_seq * len(steady) / (sum(steady) / 1e3):.1f}"
          f" sequences/s; losses {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
          f"{launches}", flush=True)
    want = {"K6": 12, "K6b": 12, "K6c": 12, "K3": 0, "K4": 0}
    bad = [st for st in steps if any(st["launches"][k] != n for k, n in want.items())]
    if len(losses) < TRAIN_STEPS or not np.isfinite(losses).all() or bad:
        raise AssertionError(f"phase 5 training: {len(losses)} losses "
                             f"{losses}; steps off their launch counts: {bad[:2]}")
    breakdown = profile_train_step(model, batches[0], dev)
    del model

    # one step's gradients, dropout off, against the f32 einsum path, on
    # the batch GRAD_TOL was derived on (grad_gap's synthetic batch 32,
    # seed 0; these are its weights too). On a batch of the random
    # detector's features the per-tensor gap measures nothing: there layer
    # 0's qkv bias gets an f32 gradient orders of magnitude below the bf16
    # paths' rounding noise, for the plain path in bf16 as for the flash one.
    oracle = grad_gap.build(init, cfg, torch.float32, dev, **grad_gap.PLAIN)
    flash = grad_gap.build(init, cfg, torch.bfloat16, dev, **grad_gap.FLASH)
    plain16 = grad_gap.build(init, cfg, torch.bfloat16, dev, **grad_gap.PLAIN)
    synth = grad_gap.synthetic_batch(cfg, n_seq, 0, dev)
    _, ref = grad_gap.step_grads(oracle, synth)
    gaps = {"flash": grad_gap.gap(grad_gap.step_grads(flash, synth)[1], ref),
            "plain_bf16": grad_gap.gap(grad_gap.step_grads(plain16, synth)[1], ref)}
    with grad_gap.zeroed_dk():
        gaps["flash_dk_zeroed"] = grad_gap.gap(
            grad_gap.step_grads(flash, synth)[1], ref)
    del ref, plain16
    print("phase 5 gradients vs f32 einsum (largest per-tensor relative L2): "
          + ", ".join(f"{k} {v[0]:.4e} ({v[1]})" for k, v in gaps.items())
          + f"; tol {GRAD_TOL}", flush=True)
    if not gaps["flash"][0] <= GRAD_TOL < gaps["flash_dk_zeroed"][0]:
        raise AssertionError(f"phase 5 gradient check: {gaps}")

    # 10 deterministic steps on two fixed batches (the derivation's two
    # synthetic batches), flash bf16 vs einsum f32
    synth2 = [synth, grad_gap.synthetic_batch(cfg, n_seq, 1, dev)]
    curves = {"flash_bf16": grad_gap.loss_curve(flash, synth2, 10),
              "einsum_f32": grad_gap.loss_curve(oracle, synth2, 10)}
    loss_gap = float(np.abs(np.subtract(*curves.values())).max())
    print(f"phase 5 losses over 10 deterministic steps: flash bf16 "
          f"{curves['flash_bf16'][0]:.4f} -> {curves['flash_bf16'][-1]:.4f}, "
          f"einsum f32 {curves['einsum_f32'][0]:.4f} -> "
          f"{curves['einsum_f32'][-1]:.4f}; max gap {loss_gap:.3e} "
          f"(tol {LOSS_TOL})", flush=True)
    if not loss_gap <= LOSS_TOL:
        raise AssertionError(f"phase 5 loss curves differ: {curves}")
    del oracle, flash

    # 3 deterministic steps under "auto": K3 and K4 forward, plain VJPs back
    auto = grad_gap.build(init, cfg, torch.bfloat16, dev)
    vjps = {"K3": 0, "K4": 0}

    def counting(module, key):
        real = module.plain_vjp

        def wrapped(*a, **kw):
            vjps[key] += 1
            return real(*a, **kw)
        return real, wrapped

    patched = [(m, *counting(m, k)) for m, k in ((fused_attention, "K3"),
                                                 (fused_ffn, "K4"))]
    tx = train_lib.build_optimizer(auto, train_lib.OptimConfig(warmup_steps=0))
    state = train_lib.create_train_state(auto, tx)
    step = train_lib.make_mlm_train_step(auto, tx, dropout=False)
    step(state, batches[0])                                  # warm-up
    torch.cuda.synchronize()
    try:
        for m, _, wrapped in patched:
            m.plain_vjp = wrapped
        zero_counts(counters)
        t0 = time.perf_counter()
        auto_losses = [float(step(state, batches[i % 2])[1]) for i in range(3)]
        auto_s = time.perf_counter() - t0
    finally:
        for m, real, _ in patched:
            m.plain_vjp = real
    auto_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"phase 5 deterministic steps under 'auto': {auto_s / 3 * 1e3:.2f} "
          f"ms/step, {3 * n_seq / auto_s:.1f} sequences/s; losses "
          f"{auto_losses}; launches {auto_launches}; plain VJPs {vjps}",
          flush=True)
    if (auto_launches["K3"] != 36 or auto_launches["K4"] != 36
            or auto_launches["K6"] or vjps != {"K3": 36, "K4": 36}
            or not np.isfinite(auto_losses).all()):
        raise AssertionError(f"phase 5 'auto' steps: launches {auto_launches}, "
                             f"plain VJPs {vjps}")
    return {"train": {"extract_ms": extract_s * 1e3, "seconds": train_s,
                      "losses": losses, "steps": steps, "launches": launches,
                      "ms_per_step": float(np.mean(steady)),
                      "sequences_per_s": n_seq * len(steady) / (sum(steady) / 1e3)},
            "step_breakdown": breakdown, "gradient_gaps": gaps,
            "loss_curves": curves, "loss_gap": loss_gap,
            "auto_train": {"ms_per_step": auto_s / 3 * 1e3,
                           "sequences_per_s": 3 * n_seq / auto_s,
                           "losses": auto_losses, "launches": auto_launches,
                           "plain_vjps": vjps}}


def check_gemm_sass(build) -> dict:
    """Counts of the Hopper instructions in the shared GEMM's kernels
    (``csrc/gemm.cu``, the functions named "wgmma_") in the built library's
    SASS (``cuobjdump -sass``): ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
    loads); raises unless each kernel issues both (the split LayerNorm
    path's first kernel, "wgmma_residual_stats", too), and the row-LayerNorm
    cluster kernel its cluster barrier (``UCGABAR``)."""
    from pathlib import Path

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            fn = next((k for k in ("wgmma_bias_act", "wgmma_residual_ln",
                                   "wgmma_residual_stats") if k in fn), None)
            if fn:
                counts.setdefault(fn, {"HGMMA": 0, "UTMALDG": 0, "UCGABAR": 0})
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += op in line
    print(f"GEMM kernels' SASS (cuobjdump): {counts}", flush=True)
    if (len(counts) != 3 or any(not c["HGMMA"] or not c["UTMALDG"]
                                for c in counts.values())
            or not counts["wgmma_residual_ln"]["UCGABAR"]):
        raise AssertionError(f"the GEMM kernels issue no wgmma / TMA / "
                             f"cluster barrier: {counts}")
    return counts


# Phase 7, the windowed path (``engine/windowed.py``). Its window ladder,
# as ``engine/windowed.WINDOW_LADDER`` holds it.
WINDOW_LADDER = ((384, 512), (448, 576), (512, 640))
# K1 at the shapes only the windowed path gives it (8 copies): on each
# rung's window, layer1 at C 256 (a stride-4 map), layer2's first block at
# C 512 stride 2 and its other blocks at stride 1; and the cascade's
# dirty-region windows of layer3 at the (384, 512) rung on the 640×1024
# canvas, [29 + 2k, 37 + 2k] for k = 1..5 (k_max is 5 there): maps ragged
# against the kernel's 128-pixel tiles.
K1_WINDOW_SHAPES = [shape for h, w in WINDOW_LADDER for shape in (
    (8, h // 4, w // 4, 256, 1), (8, h // 4, w // 4, 512, 2),
    (8, h // 8, w // 8, 512, 1))]
K1_CASCADE_SHAPES = [(8, 29 + 2 * k, 37 + 2 * k, 1024, 1) for k in range(1, 6)]
# The windowed path's features in bf16 against the full path's in bf16
# (two-level exact: the same function), as max |Δ| / max |feature| over
# the pooled dims. They may differ only where the card sums in another
# order (cuDNN and cuBLAS pick algorithms by shape: a window against a whole
# canvas, chunks of other sizes, a batch of 8 base maps against one). Sound runs on the H100 80GB HBM3 at 700 W read 0 in every
# comparison of this phase (the 16-candidate request, the dataset path at
# base_batch 8 and 1 against the full path, the cascade against the plain
# two-level path): bit-equal. 4e-3 admits one bf16 rounding step (2^-8) of
# the largest feature; the named faults read 1.6e-2 (no_trim), 6.9e-2
# (paste_shifted) and 0.19 (paint_dropped) on the request, 4.1-48x above it.
WINDOW_TOL = 4e-3
# Named faults of the windowed path, each an emulation of a slip in
# ``engine/windowed.paste_windows`` (patched here; the package has no switch
# for it): ``no_trim``, the paste's trim 0, so border cells whose receptive
# field the window cut off are pasted; ``paint_dropped``, the first copy
# gets the unpatched base map; ``paste_shifted``, each paste lands one map
# cell down and right (clamped into the map, as the paste clamps).
WINDOW_FAULTS = ("no_trim", "paint_dropped", "paste_shifted")


@contextlib.contextmanager
def window_fault(fault: str):
    """Run the windowed path with ``fault`` (one of WINDOW_FAULTS) in
    ``engine/windowed.paste_windows``."""
    from cpt_tpu_torch.engine import windowed

    real = windowed.paste_windows

    def faulty(base, wfeats, origins, stride, trim, window, canvas_hw):
        if fault == "no_trim":
            trim = 0
        elif fault == "paste_shifted":
            origins = origins + stride
        out = real(base, wfeats, origins, stride, trim, window, canvas_hw)
        if fault == "paint_dropped":
            out[0] = base
        return out

    if fault not in WINDOW_FAULTS:
        raise ValueError(f"unknown window fault {fault!r}")
    windowed.paste_windows = faulty
    try:
        yield
    finally:
        windowed.paste_windows = real


def windowed_request(rng) -> tuple:
    """A 480×640 image and 16 candidate boxes, four drawn so that each rung
    of WINDOW_LADDER takes one (on the 640×1024 canvas, halo 160) and one
    reaches past every window (the full path), twelve as ``run_requests``
    draws them."""
    img = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    designed = [[300, 200, 340, 240],     # 40×40: (384, 512)
                [270, 170, 370, 270],     # 100×100, flush top: (448, 576)
                [250, 150, 400, 300],     # 150×150: (512, 640)
                [20, 20, 620, 460]]       # the full path
    xy = rng.uniform(0, 400, (12, 2))
    wh = rng.uniform(24, 240, (12, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [639, 479])], 1)
    return img, designed + np.round(boxes).tolist()


def tsv_labels(path: str) -> np.ndarray:
    """The class of every (copy, det) of an extraction TSV's rows."""
    from cpt_tpu_torch.utils.tsv import TSVFile

    tsv = TSVFile(path)
    rows = [json.loads(tsv.seek(i)[1])["objects"][0] for i in range(len(tsv))]
    tsv.close()
    return np.asarray([b["class"] for r in rows for copy in r for b in copy])


def feature_gap(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def count_k1(extractor, k1, log: list) -> None:
    """Wrap the extractor's base pass, window functions and full path so
    that each call appends (route, K1 launches in it) to ``log``."""
    def counted(fn, route):
        def call(*args, **kw):
            n0 = k1.launches
            out = fn(*args, **kw)
            log.append((route, k1.launches - n0))
            return out
        return call

    extractor.base_fn = counted(extractor.base_fn, "base")
    extractor.fn = counted(extractor.fn, "full")
    extractor.wfns = [counted(fn, f"{h}x{w}") for fn, (h, w)
                      in zip(extractor.wfns, extractor.windows)]


def run_windowed(res, counters, smi: str, rows: list) -> dict:
    """Phase 7 (see the module docstring) on the resident weights of
    phase 4. Gathers every reading, prints it, then raises on the first
    check that failed."""
    import torch

    from cpt_tpu_torch.data.refcoco import tsv_region_features
    from cpt_tpu_torch.engine import windowed as wnd
    from cpt_tpu_torch.engine.extract import Extractor, refcoco_task
    from cpt_tpu_torch.structures.boxes import pad_boxes
    from cpt_tpu_torch.tools import cpt_predict as cp
    from cpt_tpu_torch.tools import extract_features, int8_gap

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    check(tuple(wnd.WINDOW_LADDER) == WINDOW_LADDER, "the window ladder moved")
    n_rows = len(rows)
    check_k1(rows, K1_WINDOW_SHAPES + K1_CASCADE_SHAPES, g,
             device=("grouped_conv3x3_mma",))
    k1_rows = rows[n_rows:]

    k1 = counters["K1"]
    # the resident that ``cpt_predict.build_resident(windowed=True)`` builds,
    # on phase 4's weights
    wres = cp.Resident(res.det_cfg, res.detector.state_dict(), res.bert_cfg,
                       res.oscar.state_dict(), res.tokenizer, res.device,
                       res.detector.dtype, windowed=True)
    ex = wres.extractor
    check(ex.windowed_mode == "two_level", f"windowed_mode {ex.windowed_mode}")
    log: list = []
    count_k1(ex, k1, log)
    rng = np.random.RandomState(77)

    def answer(r, img, dets, wd):
        t = time.perf_counter()
        box = cp.predict(r, img, "the person on the left", dets, workdir=wd)
        torch.cuda.synchronize()
        return box, (time.perf_counter() - t) * 1e3

    out = {}
    with tempfile.TemporaryDirectory() as root:
        # the third draw of this seed puts 3 / 6 / 5 copies on the rungs and
        # 2 on the full path; one warm-up of each path on it first
        for _ in range(3):
            img, dets = windowed_request(rng)
        answer(wres, img, dets, f"{root}/warm_w")
        answer(res, img, dets, f"{root}/warm_f")
        log.clear()
        before = dict(ex.route_copies)
        zero_counts(counters)
        box_w, ms_w = answer(wres, img, dets, f"{root}/windowed")
        launches = {k: fn.launches for k, fn in counters.items()}
        paths = k1_paths(counters, launches, "the windowed request")
        routes = {k: ex.route_copies[k] - before[k] for k in before}
        calls = list(log)
        zero_counts(counters)
        box_f, ms_f = answer(res, img, dets, f"{root}/full")
        full_launches = {k: fn.launches for k, fn in counters.items()}
        more = [(answer(wres, img, dets, f"{root}/w{i}")[1],
                 answer(res, img, dets, f"{root}/f{i}")[1]) for i in range(2)]
        fw = tsv_region_features(f"{root}/windowed/predictions.tsv")[..., :-6]
        ff = tsv_region_features(f"{root}/full/predictions.tsv")[..., :-6]
        gap = feature_gap(fw, ff)
        labels_equal = bool((tsv_labels(f"{root}/windowed/predictions.tsv")
                             == tsv_labels(f"{root}/full/predictions.tsv")).all())
        sw = cp.candidate_scores(res, f"{root}/windowed")
        sf = cp.candidate_scores(res, f"{root}/full")
        score_gap = float(np.abs(np.asarray(sw) - np.asarray(sf)).max())
        fault_gaps = {}
        for fault in WINDOW_FAULTS:
            with window_fault(fault):
                answer(wres, img, dets, f"{root}/{fault}")
            fault_gaps[fault] = feature_gap(tsv_region_features(
                f"{root}/{fault}/predictions.tsv")[..., :-6], ff)
        prof_w = profiled(lambda: answer(wres, img, dets, f"{root}/prof_w"),
                          "windowed request (16 candidates, two-level)")
        prof_f = profiled(lambda: answer(res, img, dets, f"{root}/prof_f"),
                          "full-path request (the same 16 candidates)")
    by_route: dict = {}
    for route, n in calls:
        by_route.setdefault(route, []).append(n)
    want_k1 = 11 + 50 * (len(calls) - 1)
    print(f"phase 7 windowed request (16 candidates, 480x640 image, 640x1024 "
          f"canvas; {smi}): copies by route {routes}; K1 launches by call "
          f"{by_route} = {launches['K1']} (want 11 base + 50 a chunk = "
          f"{want_k1}), by path {paths}; host ms windowed {ms_w:.1f} "
          f"{[round(m[0], 1) for m in more]}, full {ms_f:.1f} "
          f"{[round(m[1], 1) for m in more]}; copies/s windowed "
          f"{16e3 / ms_w:.2f}, full {16e3 / ms_f:.2f}; feature gap "
          f"{gap:.4e} (WINDOW_TOL {WINDOW_TOL}), labels equal {labels_equal}, "
          f"score gap {score_gap:.4e} (SCORE_TOL {SCORE_TOL}); faults "
          + ", ".join(f"{f} {e:.4e} ({e / WINDOW_TOL:.1f}x tol)"
                      for f, e in fault_gaps.items()), flush=True)
    check(all(routes[k] >= 1 for k in routes), f"a route took no copy: {routes}")
    check(by_route.get("base") == [11] and all(
        v == [50] * len(v) for k, v in by_route.items() if k != "base")
        and launches["K1"] == want_k1, f"K1 launches {by_route}")
    check(full_launches["K1"] == 50, f"full request K1 {full_launches['K1']}")
    check(box_w in dets and box_f in dets, "a box is not a candidate")
    check(np.isfinite(fw).all() and fw.shape == (16, 16, 2048),
          f"windowed features {fw.shape}")
    check(gap <= WINDOW_TOL and labels_equal and score_gap <= SCORE_TOL,
          f"windowed vs full: gap {gap}, labels {labels_equal}, scores "
          f"{score_gap}")
    check(all(e > WINDOW_TOL for e in fault_gaps.values()),
          f"a fault passes: {fault_gaps}")
    out["request"] = {"routes": routes, "k1_by_call": by_route,
                      "launches": launches, "full_launches": full_launches,
                      "ms_windowed": [ms_w] + [m[0] for m in more],
                      "ms_full": [ms_f] + [m[1] for m in more],
                      "feature_gap": gap, "score_gap": score_gap,
                      "labels_equal": labels_equal, "fault_gaps": fault_gaps,
                      "profile_windowed": prof_w, "profile_full": prof_f}
    out["launches"] = launches

    # the dataset path: 8 synthetic queries (1024×1024, 3 copies each, all
    # on the (384, 512) rung), base passes batched by 8, one a query, and
    # the full path; each run once untimed (its shapes' first use), then
    # timed once (twice, in one order and its reverse, up to PR 18; cut to
    # keep the script in its time with phases 15-16)
    def extract(root, name, flags, base_batch=None):
        path = f"{root}/{name}.tsv"
        real = Extractor.RUN_BASE_BATCH
        if base_batch is not None:
            Extractor.RUN_BASE_BATCH = base_batch
        zero_counts(counters)
        try:
            info = extract_features.main(["--synthetic", "8", "--copies_per_chunk",
                                          "8", "--output", path] + flags)
            torch.cuda.synchronize()
        finally:
            Extractor.RUN_BASE_BATCH = real
        info["k1"] = k1.launches
        info["feats"] = int8_gap.tsv_features(path)
        return info

    settings = {"batched": (["--windowed"], 8), "per_query": (["--windowed"], 1),
                "full": ([], None)}
    order = list(settings)
    runs, rates = {}, {k: [] for k in settings}
    with tempfile.TemporaryDirectory() as root:
        for k in order:
            extract(root, f"warm_{k}", *settings[k])
        for i, k in enumerate(order):
            info = extract(root, f"{k}{i}", *settings[k])
            rates[k].append(info["copies_per_s"])
            check(info["k1"] == runs.setdefault(k, info)["k1"],
                  f"dataset-path K1 launches of {k} vary")
    data_gaps = {k: feature_gap(runs[k]["feats"], runs["full"]["feats"])
                 for k in ("batched", "per_query")}
    data_gaps["batched_vs_per_query"] = feature_gap(runs["batched"]["feats"],
                                                    runs["per_query"]["feats"])
    print(f"phase 7 dataset path (extract_features --synthetic 8 "
          f"--copies_per_chunk 8; {smi}): copies/s after a warm-up, in the "
          f"order {order}: windowed base_batch 8 "
          f"{rates['batched']}, base_batch 1 {rates['per_query']}, full "
          f"{rates['full']}; K1 launches "
          f"{ {k: r['k1'] for k, r in runs.items()} } (want 411 / 488 / 400); "
          f"routes {runs['batched'].get('route_copies')}; feature gaps "
          + ", ".join(f"{k} {v:.4e}" for k, v in data_gaps.items()), flush=True)
    check([runs[k]["k1"] for k in ("batched", "per_query", "full")]
          == [411, 488, 400], "dataset-path K1 launches")
    check(runs["batched"]["windowed_mode"] == "two_level"
          and runs["batched"]["route_copies"] == {
              "384x512": 24, "448x576": 0, "512x640": 0, "full": 0},
          f"dataset routes {runs['batched'].get('route_copies')}")
    check(all(v <= WINDOW_TOL for v in data_gaps.values()),
          f"dataset-path gaps {data_gaps}")
    for r in runs.values():
        del r["feats"]
    out["dataset"] = {"runs": runs, "copies_per_s": rates, "gaps": data_gaps}

    # the cascade at the (384, 512) rung against the plain two-level path,
    # on the copies of the windowed request that fit that rung
    cfg = res.det_cfg
    task = refcoco_task("q", img, img.shape[:2], dets, "c")
    image, (h, w) = ex._canvas(task)
    win = WINDOW_LADDER[0]
    origins, fits = wnd.window_origins(task.copy_rects, win, (h, w), ex.halo)
    sel = np.nonzero(fits)[0]
    m = ex.det_bucket_for(len(dets))
    det_boxes, det_valid = pad_boxes(task.det_boxes, m)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        task.copy_rects[sel], task.copy_rect_valid[sel],
        task.copy_colors_rgba[sel], np.ones(len(sel), bool), det_boxes,
        det_valid)]
    base = wnd.make_base_early_fn(res.detector, cfg)(image)
    got = {}
    for cascade in (False, True):
        fn = wnd.make_two_level_extract_fn(res.detector, cfg, window=win,
                                           halo=ex.halo, cascade=cascade)
        zero_counts(counters)
        feats = fn(image, base, origins[sel], *args, task.image_hw)[0]
        got[cascade] = (feats[..., :-6].float().cpu().numpy(), k1.launches)
    casc_gap = feature_gap(got[True][0], got[False][0])
    h16, w16 = h // 16, w // 16
    k_max = min((h16 - win[0] // 16 - 5) // 2, (w16 - win[1] // 16 - 5) // 2, 35, 16)
    print(f"phase 7 cascade at {win[0]}x{win[1]} ({len(sel)} copies, k_max "
          f"{k_max}): gap to cascade=False {casc_gap:.4e}; K1 launches "
          f"{got[True][1]} (cascade=False {got[False][1]})", flush=True)
    check(casc_gap <= WINDOW_TOL and got[False][1] == 50
          and got[True][1] == 51 + k_max and k_max >= 1,
          f"cascade: gap {casc_gap}, launches {got[True][1]}, k_max {k_max}")
    out["cascade"] = {"copies": int(len(sel)), "k_max": k_max,
                      "gap": casc_gap, "launches": got[True][1]}
    out["k1_rows"] = k1_rows
    if failed:
        raise AssertionError(f"phase 7: {failed}")
    return out


# Phase 8: the grounding server. Most requests are 600x800 arrays (the
# shorter side is MIN_SIZE_TEST, so the server resizes nothing) with
# candidate boxes drawn as run_requests draws them; two take the resize rule
# (RESIZED_REQUESTS: 480x640 scaled up ×1.25, 1200x1600 down ×0.5, both to
# 600x800).
SERVE_CAPTION = "the person on the left"
RESIZED_REQUESTS = {"up": (2031, 480, 640, 400), "down": (2032, 1200, 1600, 1000)}


def serve_request(rng, n_dets: int, h: int = 600, w: int = 800,
                  span: float = 500) -> tuple:
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, span, (n_dets, 2))
    wh = rng.uniform(24, 300, (n_dets, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1)
    return img, np.round(boxes).tolist()


def resized_request(name: str) -> tuple:
    """One of RESIZED_REQUESTS: (image, 8 candidate boxes)."""
    seed, h, w, span = RESIZED_REQUESTS[name]
    return serve_request(np.random.RandomState(seed), 8, h, w, span)


# The Pillow-free pixel operations (utils/image_ops) on the card's host:
# SHA-256 of Pillow 12.1's output on seeded inputs (resize_digest_inputs),
# computed with Pillow on a CPU (tests/test_torch_image_ops.py holds them to
# Pillow). image_ops must reproduce each; each of IMAGE_OP_FAULTS must
# change one: nearest indices multiplied instead of accumulated, the
# bilinear support not widened when downscaling (no antialias), the
# vertical pass first, and the polygon's span ends rounded to the nearest
# integer (halves to even) instead of Pillow's ROUND_UP / ROUND_DOWN.
RESIZE_DIGESTS = {
    "serve_up":
        "056794c9f1bd6edb8cd9116e9798e3acb83a345f4d0b4be3aecebddfaf8297df",
    "serve_down":
        "6f9d35826738fab89596f6f759e8d87fef2602359ad0cd108246919aed26198f",
    "bbox_aug_0.75":
        "de398a1b8e7229aa5416b8a059e865b5d921697eeeca3e5e29ca0c38bac265dc",
    "bbox_aug_1.25":
        "d1dda1e794c7f09aeb3be4ebd0c0a63a663186eab88701d2d6d2c6c76a677190",
    "mask_nearest":
        "29de12c1d1a3670ea55d8e47232543713ec091a1a79a8c4963d58c86c0669329",
    "polygons":
        "962bd90636103d30a193c8cd5f1971407a3b5a8e0bf03b88493354a7d32429f7",
}
IMAGE_OP_FAULTS = ("nearest_multiplied", "narrow_support", "vertical_first",
                   "span_ends_plain")
SG_SYNTHETIC_SIZE = 1024         # test_detector --synthetic's canvas, phase 17


def vcr_polygon_fixture(h: int = 600, w: int = 800) -> dict:
    """Phase 9's VCR questions from polygons: one image, 6 entities with
    multi-part polygons (a part may be empty, or a single point), entity 5
    without one; two questions in the ``img_key`` layout of
    ``extract_features --task vcr``."""
    rng = np.random.RandomState(2029)
    polys = {}
    for i in range(5):
        cx, cy = rng.uniform(80, w - 80), rng.uniform(80, h - 80)
        parts = []
        for _ in range(1 + i % 3):
            n = rng.randint(3, 9)
            ang = rng.uniform(0, 2 * np.pi, n)
            r = rng.uniform(10, 90, n)
            parts.append(np.round(np.stack([cx + r * np.cos(ang),
                                            cy + r * np.sin(ang)], 1), 1).tolist())
        if i == 2:
            parts.append([])
        if i == 3:
            parts.append([[float(cx), float(cy)]])
        polys[i] = parts
    boxes = []
    for i in range(6):
        pts = np.asarray([p for part in polys.get(i, [[[40.0, 40.0],
                                                        [200.0, 160.0]]])
                          for p in part], np.float32).reshape(-1, 2)
        x1, y1 = np.maximum(pts.min(0), 0)
        x2, y2 = np.minimum(pts.max(0), [w - 1, h - 1])
        boxes.append([float(x1), float(y1), float(x2), float(y2)])
    names = ["person", "person", "dog", "cat", "man", "woman"]
    questions = [{"img_key": f"vcrpoly{q}", "img_path": "vcr.jpg",
                  "entity_ids": [[q], [1 + q, 5], [3 + q]]} for q in range(2)]
    return {"image": rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            "polygons": polys, "boxes": boxes, "names": names,
            "questions": questions}


def resize_digest_inputs() -> dict:
    """name → (image_ops function name, its arguments) of RESIZE_DIGESTS."""
    up, down = resized_request("up")[0], resized_request("down")[0]
    sg = np.random.RandomState(0).randint(
        0, 256, (SG_SYNTHETIC_SIZE, SG_SYNTHETIC_SIZE, 3)).astype(np.uint8)
    mask = (np.random.RandomState(2030).rand(480, 640) < 0.5).astype(np.uint8)
    fx = vcr_polygon_fixture()
    polys = [part for i in sorted(fx["polygons"]) for part in fx["polygons"][i]]
    s75, s125 = (int(round(SG_SYNTHETIC_SIZE * s)) for s in (0.75, 1.25))
    return {"serve_up": ("resize_bilinear", (up, (800, 600))),
            "serve_down": ("resize_bilinear", (down, (800, 600))),
            "bbox_aug_0.75": ("resize_bilinear", (sg, (s75, s75))),
            "bbox_aug_1.25": ("resize_bilinear", (sg, (s125, s125))),
            "mask_nearest": ("resize_nearest", (mask, (800, 600))),
            "polygons": ("fill_polygon", (polys, 600, 800))}


def image_op_digests(inputs: dict) -> tuple:
    """(name → SHA-256 of ``utils/image_ops``' output, name → host ms)."""
    import hashlib

    from cpt_tpu_torch.utils import image_ops

    digests, ms = {}, {}
    for name, (fn, args) in inputs.items():
        t = time.perf_counter()
        out = np.ascontiguousarray(getattr(image_ops, fn)(*args), np.uint8)
        ms[name] = (time.perf_counter() - t) * 1e3
        digests[name] = hashlib.sha256(out.tobytes()).hexdigest()
    return digests, ms


@contextlib.contextmanager
def image_op_fault(fault: str):
    """``utils/image_ops`` with one of IMAGE_OP_FAULTS."""
    from cpt_tpu_torch.utils import image_ops as io

    def narrow_taps(n_in, n_out):
        scale = n_in / n_out
        center = (np.arange(n_out) + 0.5) * scale
        lo = np.maximum((center - 1.0 + 0.5).astype(np.int64), 0)
        hi = np.minimum((center + 1.0 + 0.5).astype(np.int64), n_in)
        j = lo[:, None] + np.arange(3)[None, :]
        inside = j < hi[:, None]
        wts = np.where(inside, np.maximum(1.0 - np.abs(j - center[:, None] + 0.5),
                                          0.0), 0.0)
        wts = wts / wts.sum(1, keepdims=True)
        return np.where(inside, j, 0), (0.5 + wts * (1 << 22)).astype(np.int64)

    def vertical_first(img, size):
        out = np.asarray(img, np.uint8)
        if size[1] != out.shape[0]:
            out = io._bilinear_pass(out, size[1], 0)
        if size[0] != out.shape[1]:
            out = io._bilinear_pass(out, size[0], 1)
        return out

    def rint(v):
        return np.rint(v).astype(np.int64)

    patches = {
        "nearest_multiplied": {"_nearest_index": lambda n_in, n_out: (
            (np.arange(n_out) + 0.5) * (n_in / n_out)).astype(np.int64)},
        "narrow_support": {"_bilinear_taps": narrow_taps},
        "vertical_first": {"resize_bilinear": vertical_first},
        "span_ends_plain": {"_round_up": rint, "_round_down": rint},
    }[fault]
    saved = {k: getattr(io, k) for k in patches}
    for k, v in patches.items():
        setattr(io, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(io, k, v)


def check_resize_digests() -> dict:
    """RESIZE_DIGESTS against ``utils/image_ops`` here, and each of
    IMAGE_OP_FAULTS changing one → readings; raises on a miss."""
    inputs = resize_digest_inputs()
    got, ms = image_op_digests(inputs)
    faults = {}
    for fault in IMAGE_OP_FAULTS:
        with image_op_fault(fault):
            changed = image_op_digests(inputs)[0]
        faults[fault] = sorted(k for k in changed if changed[k] != RESIZE_DIGESTS[k])
    matched = {k: got[k] == RESIZE_DIGESTS[k] for k in RESIZE_DIGESTS}
    print(f"image_ops digests against Pillow 12.1's: {matched}; host ms per "
          f"call {({k: round(v, 2) for k, v in ms.items()})}; digests each "
          f"named fault changes {faults}", flush=True)
    if not all(matched.values()) or not all(faults.values()):
        raise AssertionError(f"image_ops digests: matched {matched}, "
                             f"faults {faults}")
    return {"matched": matched, "host_ms": ms, "faults": faults}


# The image codec (utils/image_codec, phase 21) on the card's host: SHA-256
# of Pillow 12.1.0's pixels for each committed fixture (tests/data/codec,
# written by its make_fixtures.py: JPEG with CMYK and YCCK, PNG with 16-bit,
# GIF, BMP) in RGB and L, of Pillow's JPEG bytes for each seeded array of
# codec_encode_inputs, and of the JPEG bytes of the fixture that
# validate_checkpoints --dryrun writes (Pillow at quality 92) and of
# img_info's colour probes at a step of COLOR_STEP (Pillow's default
# quality), of Pillow's decode of phase 8's quality-95 JPEG uploads, and of
# the JAX demo's caption drawing (ImageDraw.text) of caption_case, all
# computed with Pillow on a CPU (tests/test_torch_image_codec.py holds them
# to Pillow). Each of CODEC_FAULTS must change one: box replication in
# place of fancy upsampling, a float IDCT in place of islow, progressive AC
# refinement without its correction bits, YCbCr -> RGB in float arithmetic,
# the quality scaling of q + 1, PNG Paeth ties to the later predictor,
# Adobe CMYK taken as stored (not inverted), YCCK taken as CMYK, 16-bit grey
# scaled by >> 8 (not clipped), GIF's LZW code size grown one code late, a
# bottom-up BMP read top-down, caption glyphs' overlaps combined by max, and
# in the WEBP decoders the VP8 loop filter skipped, chroma replicated or
# upsampled with libjpeg's (9, 3, 3, 1) / 16 rounding (bias 7 at odd
# columns; libwebp's two averages are one rounding with bias 8), YUV -> RGB in float
# arithmetic, a 4x4 block's top-right pixels taken from its own macroblock,
# and VP8L's Select predictor taking the other neighbour; in the TIFF reader
# LZW's code width grown one code late (GIF's rule), the horizontal predictor
# ignored, JPEG-in-TIFF chroma replicated (libjpeg's other upsampler), a
# ColorMap cut to its low bytes (Pillow keeps the high ones) and edge tiles
# read at their cropped width; in the JPEG decoder jidctint.c's C
# arithmetic in place of the SSE2 / AVX2 islow's (Pillow's on x86-64: they
# part on damaged data only), arithmetic decoding without the DAC
# conditioning, every lossless sample predicted from the left, and block
# smoothing skipped. The encodes include Pillow's TIFF bytes for
# codec_tiff_encode_inputs. "damaged:<source>" is the SHA-256 over the
# outcomes of jpeg_damaged(<source>) in turn (b"raise", or the SHA-256 of
# the RGB pixels), as Pillow gives them.
CODEC_DIR = Path(__file__).resolve().parent / "tests" / "data" / "codec"
CODEC_DIGESTS = {
    "1.bmp:RGB":
        "577effce725e397e4ba5573ad05f1b486eafdf8ea42c8f0999a6d7d1aff67071",
    "1.bmp:L":
        "c81be6122e27bccb8086c3487bb9f96612492a78d660e72c5fa00695c7b4bded",
    "adam7_rgb.png:RGB":
        "fab58a19b0a52204485c42bdf3dccc0fb81e9a5e590af634d674d463b85cce58",
    "adam7_rgb.png:L":
        "f0aab2be7433f4e0fb6d1ae4b9a60182180ccb3d4dbc57acc3c2079d22a57546",
    "adobe_rgb_q75.jpg:RGB":
        "611a651ecffea6f724fa55a8ab2f681196e3a1d0e188f4dcc0411c0c3aec0fe0",
    "adobe_rgb_q75.jpg:L":
        "4b0950a7e515ca72eb2c3f0f6e4bd54e34edb31a1eba666e9f80a73925d0f9f4",
    "baseline_420_q10.jpg:RGB":
        "92350c5a9f92513ff4a9d8a851c3a06cd98a2532dc5fc66212e181553a2fca75",
    "baseline_420_q10.jpg:L":
        "49b9b1464c1a398ce34fbcbbd7db877b62f5112497b669b10601e584cc167f4d",
    "baseline_420_q75.jpg:RGB":
        "aafa46d526d013c41515e531a0ccc17e53e8eaa98ac10854cfa075b14a025cf4",
    "baseline_420_q75.jpg:L":
        "7217b6014809988f82c6ed6677d01601966b7fe7528df764c676a5995aebc09a",
    "baseline_420_q95_480x640.jpg:RGB":
        "88af2280f2c87251224bf9d9ce0626fe7b5636ef4ccaf09d714a1ac20eaee2c6",
    "baseline_420_q95_480x640.jpg:L":
        "b789ede80c2e9137c152e995f06143c851930c18974b754c344d17a80d7d96b3",
    "baseline_422_q75.jpg:RGB":
        "5de3fe720fbbee88df2c25965fa5535c6ce0a038b2924399ccbcde53e206adb4",
    "baseline_422_q75.jpg:L":
        "93e1fe2bad7131b3463d373ebf16496ef451085e53e8acf9f4c8af37c7241095",
    "baseline_444_q75.jpg:RGB":
        "5c61832a81af57a81c3639523ddd851e242540710de83bc6f954ab1590dca4ef",
    "baseline_444_q75.jpg:L":
        "d6a4d05242a103e882d1327b6cc01d7c2adf1b1e5e0592f51a62c737858d9201",
    "bitfields555.bmp:RGB":
        "f961e2339447def9c5c46fe2eb5eda1f7668f8a17cd5d368c27db7e6aa9f4061",
    "bitfields555.bmp:L":
        "67ac885a5bc067e9c10bf890050c5c22aa1a697170f670e3f545c79ee0b5d30f",
    "bitfields565.bmp:RGB":
        "6ee5c92981e8e205b075e98df42dc651a215a9b4105473bd3c254e04e7fed9e4",
    "bitfields565.bmp:L":
        "0bc8a60f0e350776838b8d335c4093bf85e83869c90e643fbe6a5c63d6acddf1",
    "cmyk_progressive_q75.jpg:RGB":
        "a2372865b55ae23f0425c89594911b2a9c976be0bb7f7797662e6ea6ff0c8c92",
    "cmyk_progressive_q75.jpg:L":
        "b2f76aa342163accc64d7dc1dcf4817f37342de149f91acd5cf64b8017341a70",
    "cmyk_q75.jpg:RGB":
        "a2372865b55ae23f0425c89594911b2a9c976be0bb7f7797662e6ea6ff0c8c92",
    "cmyk_q75.jpg:L":
        "b2f76aa342163accc64d7dc1dcf4817f37342de149f91acd5cf64b8017341a70",
    "core4.bmp:RGB":
        "bd9355a14d9d6223a0dcc88c461aa3f9eb381655ccbc1a9198d33f74da3c2e67",
    "core4.bmp:L":
        "a42a235bc6ddd5a112f3f9df47e5d5c07ba7534402445df73b7912b1dd3470bc",
    "gray_q75.jpg:RGB":
        "7b9450f6b05b2d2552abba1831fc9feed3e61c2cda6cc02e895da220286f1bc8",
    "gray_q75.jpg:L":
        "e021dc4d9701ff8da47138ff8869f339d436996321f2180f0585f6deae83a3fa",
    "i16.png:RGB":
        "9ccb463790aeaff6ec70e986ad29019ca06454597e99cf80b40a4d06e0399293",
    "i16.png:L":
        "8e551ef554607e5bf1a025932b3adf1e70c0c5dcfc4194c628d4a28e9d9f5a63",
    "l.bmp:RGB":
        "662c31ce0f888c4d65342f84c42095a53b23468f05640c5d11167142693506c4",
    "l.bmp:L":
        "ea330951310620cc84f879d83e355ba819342f7777123cb9a7bd749c5ec20a90",
    "l.gif:RGB":
        "5ad6c05301b358fcd5eaf76fab9be524c3cd9c334dd671e06b99fcbd8d72edcb",
    "l.gif:L":
        "0acfc4b74fcddcb3c7d9042f80c8e7ccfdf7d718c4c50e2321c49bc9d99fa027",
    "l.png:RGB":
        "b1f85c74c18feadc66546ceb0f454a75f6114e9167e53535d92861bf546e8559",
    "l.png:L":
        "08b913934f2e174c2e5090f8370fdd1661fee92dacce532f47e56e3b82a482d4",
    "l_interlaced.gif:RGB":
        "5ad6c05301b358fcd5eaf76fab9be524c3cd9c334dd671e06b99fcbd8d72edcb",
    "l_interlaced.gif:L":
        "0acfc4b74fcddcb3c7d9042f80c8e7ccfdf7d718c4c50e2321c49bc9d99fa027",
    "la.png:RGB":
        "b1f85c74c18feadc66546ceb0f454a75f6114e9167e53535d92861bf546e8559",
    "la.png:L":
        "08b913934f2e174c2e5090f8370fdd1661fee92dacce532f47e56e3b82a482d4",
    "la16.png:RGB":
        "fb2dd50b7ed085fce8c5356160fbce5bc140da00abe9237be561997da78f5c5c",
    "la16.png:L":
        "c74283d4d97e6c4fe3734728af44c77d10bd510cab405b8ccb727abd4bbd664b",
    "odd_481x641_q90.jpg:RGB":
        "5aa103248bb6a034668c720a4844f0f0c1bcda8744dea1a2f6f9c47c29d63bb5",
    "odd_481x641_q90.jpg:L":
        "b5fc22e8141d02b08162088a1b9a9f6cc013d1e77f99942d23682a4fd2a0f9ce",
    "optimize_q75.jpg:RGB":
        "aafa46d526d013c41515e531a0ccc17e53e8eaa98ac10854cfa075b14a025cf4",
    "optimize_q75.jpg:L":
        "7217b6014809988f82c6ed6677d01601966b7fe7528df764c676a5995aebc09a",
    "p.bmp:RGB":
        "b8a242439a00832a2fcc6990a9b3aa3ebe7c8cd2dc774cbe098000b621f45d94",
    "p.bmp:L":
        "ad12e3386a6c4cce9c39109c47c3ca29e770c6a240802e7162fdbc8f24a6fb87",
    "p.gif:RGB":
        "6bc14af1c19fef28c0243ec70bd0cfabee69773ce8ef9517829dc61dffc4963b",
    "p.gif:L":
        "9d38424531690f44b739f35b87701965ea925874f226fc49998467e55d74a1a9",
    "p1.png:RGB":
        "b7f3d0f9859d34635e15c0192f93782d5409c7bffc16e517ef355ab7b780a1bf",
    "p1.png:L":
        "e2d0a320af170bec857f2664cde88d1831797532cc1e9ac6c98785f78f127b3e",
    "p2.png:RGB":
        "37ac5ec205275e219814fdb6376c5f47f32f4f5cf3b0771c714f7695de57fef0",
    "p2.png:L":
        "b6fc54f52205571b452afaeda25658148eb6a46ad83a6eb7aa8de6e4afbc2831",
    "p4.png:RGB":
        "7088a6d2e357e0a1a4bf41850a4b1c4ec4805e4b89be2fec72fabcc33a2ce09d",
    "p4.png:L":
        "cae5e99d1203e7be4eed918ddfd1cea47eb6facd7a65773a67227089c1bb2169",
    "p8.png:RGB":
        "0fedd27ab110c96b9916bf0ef593244e7bf81d95fed1f67545563eb23c1f8f9c",
    "p8.png:L":
        "3146c218c42c4c5df09d44a21853087b5ce7502408fc8ff8a5c848d3f9a814be",
    "p_interlaced.gif:RGB":
        "6bc14af1c19fef28c0243ec70bd0cfabee69773ce8ef9517829dc61dffc4963b",
    "p_interlaced.gif:L":
        "9d38424531690f44b739f35b87701965ea925874f226fc49998467e55d74a1a9",
    "progressive_q75.jpg:RGB":
        "b159396361c914ec696d1a34b1578f7b7e20c55da6c9a8a7d654cb5c4d4a7ffd",
    "progressive_q75.jpg:L":
        "ba031bb66309f427c011617f1a33dac8b304bad80964fd5d79b3a4dc631b8ae9",
    "restart_q75.jpg:RGB":
        "aafa46d526d013c41515e531a0ccc17e53e8eaa98ac10854cfa075b14a025cf4",
    "restart_q75.jpg:L":
        "7217b6014809988f82c6ed6677d01601966b7fe7528df764c676a5995aebc09a",
    "rgb.bmp:RGB":
        "1c2b9e0813dc2c05764ba565b772de87cfeec6449f93dbd00488d26a583ecb77",
    "rgb.bmp:L":
        "ea330951310620cc84f879d83e355ba819342f7777123cb9a7bd749c5ec20a90",
    "rgb.png:RGB":
        "68a3b0b3a82269c97b9c73f339da855487f202ba4eb567eb25970c715776230f",
    "rgb.png:L":
        "08b913934f2e174c2e5090f8370fdd1661fee92dacce532f47e56e3b82a482d4",
    "rgb48.png:RGB":
        "6469aa362ea56f5a10554427a041a7b1bfefc19110e1d785e986d266162b7e0b",
    "rgb48.png:L":
        "554871fa929c1daf7cf0efa6af821c61de7bc46bd0c160f333e51cbe6bbbeee3",
    "rgba.bmp:RGB":
        "1c2b9e0813dc2c05764ba565b772de87cfeec6449f93dbd00488d26a583ecb77",
    "rgba.bmp:L":
        "ea330951310620cc84f879d83e355ba819342f7777123cb9a7bd749c5ec20a90",
    "rgba.png:RGB":
        "68a3b0b3a82269c97b9c73f339da855487f202ba4eb567eb25970c715776230f",
    "rgba.png:L":
        "08b913934f2e174c2e5090f8370fdd1661fee92dacce532f47e56e3b82a482d4",
    "rgba64_adam7.png:RGB":
        "6469aa362ea56f5a10554427a041a7b1bfefc19110e1d785e986d266162b7e0b",
    "rgba64_adam7.png:L":
        "554871fa929c1daf7cf0efa6af821c61de7bc46bd0c160f333e51cbe6bbbeee3",
    "rle4.bmp:RGB":
        "afc1e161b5bf8e15246dbc9cf2f0f5c45634586cd605b82ba5261cc9a1d5a15c",
    "rle4.bmp:L":
        "75af752e51037aada9e6de050218f8552796e7eca2d9c9f34002ac079c1a4a58",
    "rle8.bmp:RGB":
        "3d571d2e5841f20dca3a44c9591141ba51217144d619ee82499299b257981555",
    "rle8.bmp:L":
        "ca074f482bfc02973a7e6f85271c48f228818d2c30c354fa665e7b12639d799d",
    "short_palette.gif:RGB":
        "f915b15aa581dacf687f300c860c53e8ea9a65c40d57d3225d7aad01cbf564e5",
    "short_palette.gif:L":
        "bc7ce1d5e5b5d3a6540a680304ccbb98a1c8eb43916e314c4f5ef3179139069d",
    "top_down.bmp:RGB":
        "d2c28dddc802a113dedaf4c2a28a446c8b38d9c0b7c294176ad2590e2849379e",
    "top_down.bmp:L":
        "2211d3a6c817ee02ae13c092f2803a413aa2b7703d7787f4b3f8ca5aab0a4d1f",
    "ycck_q75.jpg:RGB":
        "041810a2ecb7bf6a1251b424f5ee71b3e23d20258ecbdaa40b3c2eb2002268bd",
    "ycck_q75.jpg:L":
        "2deb17979de87d8ebeda46d9c7f2fba61e25e611666372b2d8c212ca9562bc74",
    "lossy_q10.webp:RGB":
        "57d7a34da840ad51b9e19db7666ad5f2df6ba2482a038d5cdd41498540dacae0",
    "lossy_q10.webp:L":
        "349456383831421d61e62c6cd4e9a6ff09295ee4b4aa56e443c09cfa1e54bcd1",
    "lossy_q75.webp:RGB":
        "3757c214066643f04eb448bf2beb9371a1f53f51aa5c7619c83ed43eab8e0aa9",
    "lossy_q75.webp:L":
        "f1fa8292ac26af900e33c5dd13fc7fc54c2b325ae0463703ade35e288995cb23",
    "lossy_q95_m6.webp:RGB":
        "8e137d0a88e97fd8b8c630e20f631d7daab9074f6347d47b921f8b8b24856257",
    "lossy_q95_m6.webp:L":
        "66260f06d1c805e12a33a86cfca78de311f563319fd82642f504733fd0d0d085",
    "lossy_q75_m0.webp:RGB":
        "faeca76f5acb15dd09bf21b4807385dbdf1762e705f99c7ab69a31358af13746",
    "lossy_q75_m0.webp:L":
        "855e626bfbb9629e11d0daae3a9249b7cb7f3b867385388e731745de048efd18",
    "lossy_alpha_q75.webp:RGB":
        "5f636fe5b47458300b9769b5b32572f854446ccb7299f1dfc1d8a3a8eeb10de6",
    "lossy_alpha_q75.webp:L":
        "c69e44eecbdfa0e2511f74c249fc7df7397256c494b7f71b000c68ac6a62f5c2",
    "lossless_rgb.webp:RGB":
        "c1035264ad623339376757cc62d149bab41e24f2444d7b1e886505d3ebb10580",
    "lossless_rgb.webp:L":
        "84ccdce75b34aeb00ec8f77e7c8486aa1e37d3a3b299e27f454a449129ff8651",
    "lossless_rgba.webp:RGB":
        "633f7b945b0e739688f4e3982454f9c1d7d6175c928afec5d8e262a21dab75d5",
    "lossless_rgba.webp:L":
        "568fa3422b5427526278b732e60bbef7cc58430300c4dffcd938da0e7a541b85",
    "odd_481x641_q80.webp:RGB":
        "1f53d27ea5416ef28245be8e2e3c6878d9792051ae5dce9aca069289401af572",
    "odd_481x641_q80.webp:L":
        "0214f04b71dc2dad9890ef555622eb2555e26e1242f6cc05e55aa9b33824ff28",
    "one_pixel.webp:RGB":
        "d82089511d3225bb61991a968cf9d457588a7f46094bf8e361e7c3846d74fa1f",
    "one_pixel.webp:L":
        "383e5d7d58caa41ce723cf16af471b38f6ee9065c032d07fa6bef1678cb72f1d",
    "palette4_lossless.webp:RGB":
        "b9e12b059607bf6c62c11af191f9142f4490fb36342730be822d6649e3a97334",
    "palette4_lossless.webp:L":
        "5f3c1b1d50539bbaf9fb27f71475471f5e28e0af375d9a445112d407eb6d6684",
    "anim_2frames.webp:RGB":
        "91bbc20cd644e8b5b79e688797f0d1d5567f4887032078a764aef6fd82fb9d84",
    "anim_2frames.webp:L":
        "40e056c2c2b00f518a7a242c0d63a9c44cab73bf12dfc23579d60bd17fc8bd7d",
    "simple_filter.webp:RGB":
        "3a0e49c367fc0c91d9196422661128b1933aa48834c96c4c4fcd2d20baa45d46",
    "simple_filter.webp:L":
        "31ef0070973e67232a5f937dc70e5341ca33aa118b8d3e3738323e4161a38ebb",
    "partitions4.webp:RGB":
        "3757c214066643f04eb448bf2beb9371a1f53f51aa5c7619c83ed43eab8e0aa9",
    "partitions4.webp:L":
        "f1fa8292ac26af900e33c5dd13fc7fc54c2b325ae0463703ade35e288995cb23",
    "partitions8.webp:RGB":
        "c39c13411b9c576d0877ec1939620dbcaab34133ac02781f18c721c66754056a",
    "partitions8.webp:L":
        "05a8dd99a0f206684b919d6963436700a281c872d83d3b695b65ba66b456e35b",
    "one_segment.webp:RGB":
        "fd6bc019b992bb4bd58c4c4f86550761c6839e041fc041f9379d4c47e373941d",
    "one_segment.webp:L":
        "c21c2597f68fde350fc304e516417ffdd9bb636fe17174108a9826469b54adb6",
    "sharpness7.webp:RGB":
        "7dd15bb2b510b34390499ec23c750b64ee47d308cc720ce842f4028d65885dfa",
    "sharpness7.webp:L":
        "ffa84efbed3ed70a1143702cd49d71346657473f34002a648ab2eaf23713a501",
    "alpha_raw.webp:RGB":
        "5f636fe5b47458300b9769b5b32572f854446ccb7299f1dfc1d8a3a8eeb10de6",
    "alpha_raw.webp:L":
        "c69e44eecbdfa0e2511f74c249fc7df7397256c494b7f71b000c68ac6a62f5c2",
    "alpha_filtered.webp:RGB":
        "5f636fe5b47458300b9769b5b32572f854446ccb7299f1dfc1d8a3a8eeb10de6",
    "alpha_filtered.webp:L":
        "c69e44eecbdfa0e2511f74c249fc7df7397256c494b7f71b000c68ac6a62f5c2",
    "anim_offset.webp:RGB":
        "a72913c2587d08374b45d8efe93757460e9c10cc499fcfa710657192457dc19c",
    "anim_offset.webp:L":
        "7c977b6d066d0f8bc3c77cc9cad78335a33e7d3d35f30237b4041ef559df0236",
    "photo_480x640_q75.webp:RGB":
        "63d1d77665dcd7ac0b3bfcffac10b76e9c8683d94ddfb04e658f6ee358446bf9",
    "photo_480x640_q75.webp:L":
        "80c54ab677677cf2c4bcfe4f1f49f62fd8008ba2520c4ffc9bf47844b130a6b1",
    "photo_480x640_q95.webp:RGB":
        "fad1dea401907971259cede734050ee4c6fb9ac636b34b03be4fd2c8c5bead81",
    "photo_480x640_q95.webp:L":
        "afcca466a07afeb233c6184f37c908c12dda95852c05550748d4cfcbba654ff6",
    "alpha_480x640_q75.webp:RGB":
        "4174d907ebb8c9deeeafaebb42d2e6ef73a716dc158923b776de00842649bd66",
    "alpha_480x640_q75.webp:L":
        "0cbb59a6694f2ec3667aaca36e0b0291822089d65aaa9113f55a9187c4fcca99",
    "lossless_480x640.webp:RGB":
        "28ccc8bbae73cdc25c990c46c378666b649f50495459e238d9c6f491f2e6c7d0",
    "lossless_480x640.webp:L":
        "52f836a911ace7535e0392d8f3e582e4e6a148ff90f9d15d788f29388ab22cdc",
    "encode:photo_q75":
        "c834338477581840d666dbb566fff640fb7b5a293340c1675c0d5d3f28c9daec",
    "encode:photo_q92":
        "9daf68e65bad6a4c7083288895cd1b6fce9660ff51da3713f0f5c28a35205ce7",
    "encode:photo_q95":
        "948366e74edd3af18323f6138bc990d73333956d2ed25e67de4e62fe7558bab3",
    "encode:noise_q92":
        "4eb51ea7e92d76260e0d17825dcd36b7576ae61ba030121901776aa78a65272a",
    "encode:gray_odd_q75":
        "2e0ffacd672ed86e16a89178dd65ad5976c96b1636f1debfca1e989afba4bd59",
    "upload:up":
        "80eec2441404759382cd2de1275cc531394f51bc27dae322f33837140f23c369",
    "upload:down":
        "d199e1930f373ab56c8e9a0778f7fc9d6a8d5510fbafc1ecacdb2cbcff1f66ce",
    "img_info:colors":
        "3716360b0f0f8126dd03ead206225ad0fbdf4389c83006ed97087f8cfc443984",
    "validate:fixture":
        "a5c86d16c04f033acac534e3edfa7fed17ad23f8c5cdb8657bac7d9176460f94",
    "caption:overlay":
        "eebae697a02692b7940c5c001ecf3dac0f97b7c15cd145f3eeff78db5d46fb9a",
    "rgb_raw.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgb_raw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "l_raw.tif:RGB":
        "c91a08a5dca3a366ce1bde5e411bb74208a989f3197f04dcf204ad988a0e4e00",
    "l_raw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "bilevel_raw.tif:RGB":
        "0d7e980577b7b55091d22d185b1873267f07caef612f68511da98f2da38d2be5",
    "bilevel_raw.tif:L":
        "a4302f07f88088e33d788a2c6aade5126997249d561feef49f2a23e185803697",
    "p_raw.tif:RGB":
        "657060ab6c2212b5e08ba04ae3153834a6d64663f5eface12e12e15c430f005e",
    "p_raw.tif:L":
        "e86168a6dcac0f977b848da7cf8fff53a843fecc1551578ca055ec51ac09817a",
    "rgba_raw.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgba_raw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "la_raw.tif:RGB":
        "c91a08a5dca3a366ce1bde5e411bb74208a989f3197f04dcf204ad988a0e4e00",
    "la_raw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "cmyk_raw.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "cmyk_raw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "i16_raw.tif:RGB":
        "28b1f0c642a34dfcf5206859ced058646b115c908d0b05b5ef6201f796180c21",
    "i16_raw.tif:L":
        "7c8f7f9146c074be43c4d324de56bcd53a322fbbe1ad1fa230c586eb02a1cb91",
    "mm_i16_raw.tif:RGB":
        "28b1f0c642a34dfcf5206859ced058646b115c908d0b05b5ef6201f796180c21",
    "mm_i16_raw.tif:L":
        "7c8f7f9146c074be43c4d324de56bcd53a322fbbe1ad1fa230c586eb02a1cb91",
    "bigtiff_raw.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "bigtiff_raw.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "rgb_packbits.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgb_packbits.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "bilevel_packbits.tif:RGB":
        "0d7e980577b7b55091d22d185b1873267f07caef612f68511da98f2da38d2be5",
    "bilevel_packbits.tif:L":
        "a4302f07f88088e33d788a2c6aade5126997249d561feef49f2a23e185803697",
    "rgb_lzw.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgb_lzw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "rgb_lzw_pred.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgb_lzw_pred.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "l_deflate_pred.tif:RGB":
        "c91a08a5dca3a366ce1bde5e411bb74208a989f3197f04dcf204ad988a0e4e00",
    "l_deflate_pred.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "rgb_deflate.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgb_deflate.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "rgba_lzw.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "rgba_lzw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "la_deflate.tif:RGB":
        "c91a08a5dca3a366ce1bde5e411bb74208a989f3197f04dcf204ad988a0e4e00",
    "la_deflate.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "cmyk_lzw.tif:RGB":
        "15419be5b4e33ed06e9dfe1e4f1aea7b58265926b1988c77f627d229b5742d30",
    "cmyk_lzw.tif:L":
        "337f802a20d7eb0cb5af95ed8523197276b6f3f1f2314abefd5aa6048c0f619e",
    "p_lzw.tif:RGB":
        "657060ab6c2212b5e08ba04ae3153834a6d64663f5eface12e12e15c430f005e",
    "p_lzw.tif:L":
        "e86168a6dcac0f977b848da7cf8fff53a843fecc1551578ca055ec51ac09817a",
    "i16_lzw.tif:RGB":
        "28b1f0c642a34dfcf5206859ced058646b115c908d0b05b5ef6201f796180c21",
    "i16_lzw.tif:L":
        "7c8f7f9146c074be43c4d324de56bcd53a322fbbe1ad1fa230c586eb02a1cb91",
    "bigtiff_lzw.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "bigtiff_lzw.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "ycbcr_lzw.tif:RGB":
        "a427f3cd46cc360fe0540cb919eeef266ad2332b37f0391651c632911ca71adb",
    "ycbcr_lzw.tif:L":
        "c2962c3d9837c0cab5224bdd0e9cb081cce87439da219e9f26d077245140157f",
    "ycbcr_jpeg_11.tif:RGB":
        "32a1302d4424d0be767ead0c596e31cb835a8ff5c5d5de21c7f2301a03999abc",
    "ycbcr_jpeg_11.tif:L":
        "6d79225902bf093c72b5a06706979fc8bb6958dcd9c26e720c4cbb7cd8d2df10",
    "rgb_jpeg.tif:RGB":
        "072279a5f65a8ff267c5bccce11c13699dd22b14074fe9d16621f71235a845ce",
    "rgb_jpeg.tif:L":
        "5aafa53458620e4d70c8d1ffe46fa89a70d91cfa60e56a74b3e2dd2d8df5e8a6",
    "l_jpeg.tif:RGB":
        "e35cdeef13602a5e34c913f8660871198799f800f9a7e91f6484ce919ccb8098",
    "l_jpeg.tif:L":
        "bc71b43977d00e5532e5fd96a758803e4c690a86e2cd8a419078a710435b6a19",
    "ycbcr_jpeg_22.tif:RGB":
        "cd1aae7f8163a6ba834b74d78d16000574436a8c99f3a5ab9f673075f78c2524",
    "ycbcr_jpeg_22.tif:L":
        "716d211485be9ff312a3a1e12271dd365c0a6d07c292c9973f30cb98ed70b4fd",
    "ycbcr_jpeg_21.tif:RGB":
        "077e69a0add07f68adc56e421a7a928d10b4eeedf7d539c001a589cdbc1c9b28",
    "ycbcr_jpeg_21.tif:L":
        "716d211485be9ff312a3a1e12271dd365c0a6d07c292c9973f30cb98ed70b4fd",
    "ycbcr_jpeg_22_tiles.tif:RGB":
        "5a9dbd3b560fb4a0bb1d2b208d4cc38f4999cc38c570ffa9132976f637f43f3b",
    "ycbcr_jpeg_22_tiles.tif:L":
        "e3e718b876f433fc67df5f5e767c03b997e3c0637636476b6fd36b4caeb5525c",
    "ycbcr_lzw_22.tif:RGB":
        "b2ad6987433ab6a24160b6bcae29217e508c784916c3c6e7216a55152981774c",
    "ycbcr_lzw_22.tif:L":
        "c7995a55e4ff311bd6481609e7ff0aa7687ee01ebe78dbe4844143ca1bee44ff",
    "ycbcr_deflate_42.tif:RGB":
        "6b8ef3c5c0593de735bb31521b74e3e477284aef9f8d43ae439550b3fc6eb950",
    "ycbcr_deflate_42.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "tiles_lzw_pred.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "tiles_lzw_pred.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "tiles_deflate_l.tif:RGB":
        "867bb9810a7333cd250ee4ce4138bcd9c61ef40ffc2475dd6bbe116e8f2cfed9",
    "tiles_deflate_l.tif:L":
        "923469e2771758a94b36b50220f920ba0a86f432efa1822f28b6582c157c6a32",
    "tiles_packbits.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "tiles_packbits.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "tiles_raw.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "tiles_raw.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "planar_lzw.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "planar_lzw.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "planar_deflate_rgba.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "planar_deflate_rgba.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "planar_raw.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "planar_raw.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "mm_lzw_pred.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "mm_lzw_pred.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "mm_rgb16_lzw_pred.tif:RGB":
        "83360eb07ce80fd92de4dcc4c9a01b6e759a0aa4a8b5e0d752b2d33b2cbe46a0",
    "mm_rgb16_lzw_pred.tif:L":
        "8b3245f2f04ebedde525a63c532753da329623854a77fb60736443025874f012",
    "rgb16_deflate.tif:RGB":
        "83360eb07ce80fd92de4dcc4c9a01b6e759a0aa4a8b5e0d752b2d33b2cbe46a0",
    "rgb16_deflate.tif:L":
        "8b3245f2f04ebedde525a63c532753da329623854a77fb60736443025874f012",
    "rgba_assoc_lzw.tif:RGB":
        "8d285d3267ce95fcb2d7ed3debd0e31bdc729aa0a1a22cb8a5632c9964994d64",
    "rgba_assoc_lzw.tif:L":
        "31ff3871d9aafc59cbfe5a682c60822545d7b28f5940b413fa309f2bfa5bf6cc",
    "rgba_assoc_planar.tif:RGB":
        "681ad842ea3a20c675143e0e77aa3d4819c4a329a7c6051b5ec9832b41f364fc",
    "rgba_assoc_planar.tif:L":
        "1fdd9de1b31117e717691bfa1615c820b2374b4726a45388f4695e7843175c05",
    "palette4_lzw.tif:RGB":
        "5f837ab8cd1514d4cd41c40f0a7e3856e4629f6758f3858182ee670308f88baf",
    "palette4_lzw.tif:L":
        "d8a25a240514e2161c56cf7d010b5b2f0768861b8666b5a47d2cb634183b8cd3",
    "grey2_packbits.tif:RGB":
        "40502dfe539566d200100ccc27a7eca99bfef6f556cb9dd266ff20807bbc49bb",
    "grey2_packbits.tif:L":
        "29fab8db45f58e09d2169190e49ecb152c770c04df3d249d276e939cc117269c",
    "palette8_raw.tif:RGB":
        "84b0996656af24e07d8aede2db006713669f9be7c4161812c5bf747f35ff0356",
    "palette8_raw.tif:L":
        "c1d01bf49e4cb71f449bde7a7effd5d8629501cfdad24bf9c296ab2b96cf2dbb",
    "fill2_lzw.tif:RGB":
        "014fbd45235760e6af5477a2829ba9f4d1d7c7c1fcffb73f2972e52e71eb1f34",
    "fill2_lzw.tif:L":
        "e6e275e56fdd607224fbc19e6f678af2a1f68e0974621c560b1c4b4fc7fccf90",
    "whiteiszero_raw.tif:RGB":
        "e1b295586723d29c23cb30133fb506108a10fb4be147517d4364069b300e2b61",
    "whiteiszero_raw.tif:L":
        "07e9f0c7c578e1622764de59778720d35c488cbfd288e1e64c7b6b545c772cd4",
    "ycbcr_jpeg_22_480x640.tif:RGB":
        "3467227c2843b801ad359a4b89fc111ba67c933ef81c243c1a1d056a401bb44d",
    "ycbcr_jpeg_22_480x640.tif:L":
        "b5be574ba6fbd36d357895764582dc9982420414ab3cce02c582bc57c9fa1804",
    "encode_tiff:photo_rgb":
        "b1f3fff743416a523d8d34d44ede0110d2dd6fe4137cfa9416dbdeefee22e9bf",
    "encode_tiff:gray_odd":
        "3b1b0c2ac9c90027a2c5183f9ef94dc1793223f8d77a6cdc91c697d00941300d",
    "damage_baseline_420.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "damage_baseline_420.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "damage_baseline_444.jpg:RGB":
        "bdbc2a3269d2083ea22f5bc728b9b6245a4661c562b2144dfe43aa8b9babf228",
    "damage_baseline_444.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "damage_restart.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "damage_restart.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "damage_optimize.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "damage_optimize.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "damage_progressive.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "damage_progressive.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "damage_gray.jpg:RGB":
        "f57cc4d9e6de804d491617f92c9be098cce3263db24e6e2d6cbb474d7ec87436",
    "damage_gray.jpg:L":
        "977b43f49d6b26f77c24eaee7b7ec17a16fbcd47edec5d8ac182044ddbe6cb1d",
    "damage_cmyk.jpg:RGB":
        "368d87a127c78abbf58e1fe51c7ab471465ba47512ee897b12bb76bd4f3af3ff",
    "damage_cmyk.jpg:L":
        "b83c105a1b68cae2e5302950b1e2cac4ea7dbd0ef48801dbc3085fd330d3a988",
    "arith_420_q75.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "arith_420_q75.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "arith_444_q75.jpg:RGB":
        "bdbc2a3269d2083ea22f5bc728b9b6245a4661c562b2144dfe43aa8b9babf228",
    "arith_444_q75.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "arith_gray_q75.jpg:RGB":
        "f57cc4d9e6de804d491617f92c9be098cce3263db24e6e2d6cbb474d7ec87436",
    "arith_gray_q75.jpg:L":
        "977b43f49d6b26f77c24eaee7b7ec17a16fbcd47edec5d8ac182044ddbe6cb1d",
    "arith_no_dac_q75.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "arith_no_dac_q75.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "arith_dac_q75.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "arith_dac_q75.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "arith_restart_q75.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "arith_restart_q75.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "arith_progressive_q75.jpg:RGB":
        "b18adafbe735213c0c1f6dd958d89607b4c78bb0dcd49781669cf1b5ec84d72b",
    "arith_progressive_q75.jpg:L":
        "6df27ef5594af5396de5ea1ce14203eada5da4c93a3d075b970bb342764e3043",
    "arith_cmyk_q75.jpg:RGB":
        "72642567c6d5dfe031174a2690df4f0be1501921e353d923c934ca7f10e07d79",
    "arith_cmyk_q75.jpg:L":
        "fe2f74a1e0b16a66452888eb4d734bc455cf1304481bb495d59afa8cf9cae93b",
    "lossless_gray_p1.jpg:RGB":
        "78f63a822cd654b30847b1d6c1b548b94f6d8c81612a41d384973f5641c18e2f",
    "lossless_gray_p1.jpg:L":
        "549e28b8f35d5c8c7f2601e43c9e98f863e86397880344116c2da2b2cc7615f4",
    "lossless_rgb_p1.jpg:RGB":
        "e2ab5e9f567c6257e83e822ce1526fde882c8dc14543741cb682a66eddc2e5cb",
    "lossless_rgb_p1.jpg:L":
        "7f72544b54f40ca85d1ab59bcc491b0369ba184dac7e795915cdb9e63074cc5e",
    "lossless_gray_p4.jpg:RGB":
        "78f63a822cd654b30847b1d6c1b548b94f6d8c81612a41d384973f5641c18e2f",
    "lossless_gray_p4.jpg:L":
        "549e28b8f35d5c8c7f2601e43c9e98f863e86397880344116c2da2b2cc7615f4",
    "lossless_rgb_p4.jpg:RGB":
        "e2ab5e9f567c6257e83e822ce1526fde882c8dc14543741cb682a66eddc2e5cb",
    "lossless_rgb_p4.jpg:L":
        "7f72544b54f40ca85d1ab59bcc491b0369ba184dac7e795915cdb9e63074cc5e",
    "lossless_gray_p7.jpg:RGB":
        "78f63a822cd654b30847b1d6c1b548b94f6d8c81612a41d384973f5641c18e2f",
    "lossless_gray_p7.jpg:L":
        "549e28b8f35d5c8c7f2601e43c9e98f863e86397880344116c2da2b2cc7615f4",
    "lossless_rgb_p7.jpg:RGB":
        "61d3c8f9036aeb319b727946ba7234297219e26f7baafff236bc923eb6b0fb87",
    "lossless_rgb_p7.jpg:L":
        "952b30e62fd7284aad3e382f901917ff11d0961c57b95ac5e39c8e574d72e1fa",
    "lossless_420.jpg:RGB":
        "13331723dcaedb12aa7c69692cdad0e3e7aecfefbf508e61a4f44ce7d3d42669",
    "lossless_420.jpg:L":
        "d21a7dbbac6947b19f68d70976423cae4376c01180379b5af6aa3f0162212344",
    "lossless_ids123.jpg:RGB":
        "3a22a6061aaa2fddeb20aa58b24ee3bb33c55f05419caac127f5cf33235b8562",
    "lossless_ids123.jpg:L":
        "371ea8d92dacb329caf27069ad78a9f9846a5fca3999a85dab3d1a0023a507c9",
    "smooth_drop1.jpg:RGB":
        "3ca5ba47fd7bdb8357fda29f1fed487c73a5ccc96e3d0c951814a440f99ab8ae",
    "smooth_drop1.jpg:L":
        "42007210938fee7d0f8d6f9b159be01b5c00d86d538369d8e63f9ec49f8b3a87",
    "smooth_drop2.jpg:RGB":
        "fd35a99336e4358559dba8d1842df6730750c9e62a7e1352ecd217c46578df9e",
    "smooth_drop2.jpg:L":
        "6440e30f745880fc27a0dc38415b3105f2c241fe62049599588b5efc29593f39",
    "smooth_drop4.jpg:RGB":
        "7b6c862739a4bf350bcbdcea9b0c9e39cebdd8a771ac65c9e2d4e19e8a2d8c40",
    "smooth_drop4.jpg:L":
        "ec47b022a4c720551c1cf78f62ea5d08788305102b88a502381fffb2d299d084",
    "smooth_drop6.jpg:RGB":
        "341deaf857802dfa40b5b64122953a1826a7456e2389bf8b35b0b0474116cbf3",
    "smooth_drop6.jpg:L":
        "208ff5ed5410b43b455001f38c4083866416da987ab18f798ba3172ca6adf77e",
    "arith_progressive_q50_480x640.jpg:RGB":
        "acb1cd310dceccfad97d8ae6be108a3b000ae6c38f2e68532f212cc36ccd540a",
    "arith_progressive_q50_480x640.jpg:L":
        "117ce282e32ca8e7779fc6ad1be24763eab9ce6c4d6dbeb1492a17ce98bb08c4",
    "smooth_480x640.jpg:RGB":
        "03a2408e6a7787db5c4b7ca94d71526006656a37f4a500a1ce0894271ebd6661",
    "smooth_480x640.jpg:L":
        "1006969c1e326f9a3df7fa07f26608468ed54735498d3dc3785386a4859bfe42",
    "lossless_gray_480x640.jpg:RGB":
        "ceb87381775d45cb8888589677f346f46cea7591fe79e2c0c76149d2cc9dcd03",
    "lossless_gray_480x640.jpg:L":
        "5ef58d3f0558948fd6b0f737f9d68ef5e2f12de23a92191343ea5ff8d9a76bfe",
    "damaged:damage_baseline_420.jpg":
        "d6a8b15b5bd886ca3af176309caf635c7a6421f329643e73dda79c6e396e25bc",
    "damaged:damage_baseline_444.jpg":
        "6eff99df2f7b498e520dc7ef541b8cfb80c003448c8f7385c5de3ae9b32963de",
    "damaged:damage_gray.jpg":
        "53a6996e5c2549b183b4e1955eb89a4706beedd93035071c9b36f21408c5d3e0",
    "damaged:damage_restart.jpg":
        "78b7614f6a9195476ba4f0a0729f37457a9677f2eb9495cdb65e9bd0bc9d739b",
    "damaged:damage_optimize.jpg":
        "e7f295d4d3326043127b5684c4abb0f242e70d093b95621697225f1f3425460c",
    "damaged:damage_progressive.jpg":
        "c85edb6c57f4efbf01dc579d1c1979919092d5b63426e4e736a79b59515d7a55",
    "damaged:damage_cmyk.jpg":
        "3edb457f447fddd86315be620241660607070077097551701f4408c1a61a6d06",
    "damaged:arith_420_q75.jpg":
        "51467c839285da5224ba1962367d2742d587cb8b53e335832231e0d25e62a06a",
    "damaged:arith_progressive_q75.jpg":
        "4aeb43f8f4f3be1e0dc031e7e328c4d790b826db6ca8cc83b3eafd360b83ec6e",
    "damaged:lossless_rgb_p4.jpg":
        "296b1348b144962f1e17e6aa05104663c127239b1fa6035609528f35478dc3b8",
}
CODEC_FAULTS = ("replicate_upsample", "float_idct", "refine_no_correction",
                "float_ycc", "quality_off_by_one", "paeth_ties",
                "cmyk_not_inverted", "ycck_as_cmyk", "sixteen_bit_shift",
                "gif_late_growth", "bmp_top_down", "caption_max",
                "webp_no_loop_filter", "webp_box_upsample",
                "webp_single_round_upsample", "webp_float_yuv",
                "vp8_top_right", "vp8l_select_swapped",
                "tiff_lzw_late_growth", "tiff_no_predictor",
                "tiff_jpeg_replicate", "tiff_colormap_low_byte",
                "tiff_edge_tile_stride", "c_idct", "arith_default_conditioning",
                "lossless_left_predictor", "no_block_smoothing")
# the fixtures each fault runs over (its own format's; "" none): a faulted
# run decodes only those, and encodes only for a JPEG fault
CODEC_FAULT_FILES = dict(
    {f: ".jpg" for f in ("replicate_upsample", "float_idct",
                         "refine_no_correction", "float_ycc",
                         "quality_off_by_one", "cmyk_not_inverted",
                         "ycck_as_cmyk", "c_idct", "arith_default_conditioning",
                         "lossless_left_predictor", "no_block_smoothing")},
    paeth_ties=".png", sixteen_bit_shift=".png", gif_late_growth=".gif",
    bmp_top_down=".bmp", caption_max="",
    **{f: ".webp" for f in CODEC_FAULTS if "webp" in f or "vp8" in f},
    **{f: ".tif" for f in CODEC_FAULTS if f.startswith("tiff_")})
# Pillow 12.1.0's host ms (libjpeg-turbo 3.1.3, libwebp 1.6.0, libtiff
# 4.7.1), the median of 20 calls of ``python3 image_codec_timing.py`` on an
# 8-core Intel Xeon host with no card: decode of the 480x640 quality-95
# fixture, encode of the 480x640 photo at quality 95, decodes of
# CODEC_WEBP_TIMED and CODEC_TIFF_TIMED, the TIFF encode of the 480x640
# photo of codec_tiff_encode_inputs; and, from a later run on such a host,
# the decodes of CODEC_JPEG_TIMED.
# The card's host has no Pillow; phase 21 prints the codec's ms there
# beside these.
CODEC_PILLOW_MS = {"decode_480x640_q95": 4.6502935019816505,
                   "encode_480x640_q95": 2.5981564995163353,
                   "photo_480x640_q75.webp": 7.487,
                   "photo_480x640_q95.webp": 15.767,
                   "alpha_480x640_q75.webp": 11.16,
                   "lossless_480x640.webp": 6.945,
                   "ycbcr_jpeg_22_480x640.tif": 3.294545499556989,
                   "arith_progressive_q50_480x640.jpg": 4.1986649998762005,
                   "lossless_gray_480x640.jpg": 2.3588909998579766,
                   "smooth_480x640.jpg": 3.2537100000809005,
                   "encode_tiff_480x640": 0.8357690003322205}
# the damaged JPEG corpora's sources (24x30; make_fixtures.jpeg_fixtures):
# Pillow's baseline 4:2:0 and 4:4:4, grey, restart, optimized, progressive
# and CMYK files, libjpeg-turbo's arithmetic sequential and progressive and
# lossless ones. Their "damaged:" digests cost ~1 s, so of the faulted runs
# only CODEC_DAMAGE_FAULTS' take them.
JPEG_DAMAGE_SOURCES = ("damage_baseline_420.jpg", "damage_baseline_444.jpg",
                       "damage_gray.jpg", "damage_restart.jpg",
                       "damage_optimize.jpg", "damage_progressive.jpg",
                       "damage_cmyk.jpg", "arith_420_q75.jpg",
                       "arith_progressive_q75.jpg", "lossless_rgb_p4.jpg")
CODEC_DAMAGE_FAULTS = ("c_idct",)
CODEC_JPEG_TIMED = ("arith_progressive_q50_480x640.jpg", "lossless_gray_480x640.jpg",
                    "smooth_480x640.jpg")
CODEC_WEBP_TIMED = ("photo_480x640_q75.webp", "photo_480x640_q95.webp",
                    "alpha_480x640_q75.webp", "lossless_480x640.webp")
CODEC_TIFF_TIMED = ("ycbcr_jpeg_22_480x640.tif",)
VALIDATE_FIXTURE = {"n_images": 20, "canvas": (128, 128)}   # --dryrun's


def codec_photo(seed: int, h: int, w: int) -> np.ndarray:
    """A photo-like RGB image (gradients, flat discs, mild noise), as
    ``tests/data/codec/make_fixtures.photo`` draws it."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    128 + 100 * np.sin(x / 17.0) * np.cos(y / 23.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 60)
        img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.randint(0, 256, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def codec_encode_inputs() -> dict:
    """name → (uint8 array, JPEG quality) of CODEC_DIGESTS' encodes."""
    photo = codec_photo(11, 480, 640)
    noise = np.random.RandomState(12).randint(0, 256, (128, 128, 3)).astype(
        np.uint8)
    return {"photo_q75": (photo, 75), "photo_q92": (photo, 92),
            "photo_q95": (photo, 95), "noise_q92": (noise, 92),
            "gray_odd_q75": (codec_photo(13, 241, 321)[:, :, 1], 75)}


def codec_tiff_encode_inputs() -> dict:
    """name → uint8 array of CODEC_DIGESTS' TIFF encodes ("encode_tiff:")
    (Pillow's save(format="TIFF") of each)."""
    return {"photo_rgb": codec_photo(11, 480, 640),
            "gray_odd": codec_photo(13, 241, 321)[:, :, 1]}


def codec_fixture_files() -> list:
    return sorted(p for p in CODEC_DIR.iterdir()
                  if p.suffix in (".jpg", ".png", ".gif", ".bmp", ".webp", ".tif"))


def jpeg_damaged(data: bytes, seed: int):
    """The damaged files of one JPEG_DAMAGE_SOURCES source: every 20th
    truncation point, then each 3rd byte flipped by xor 1, 0x80, 0xff and a
    value drawn from ``seed``."""
    rng = np.random.RandomState(seed)
    for n in range(0, len(data), max(1, len(data) // 20)):
        yield data[:n]
    for i in range(0, len(data), 3):
        for x in (1, 0x80, 0xFF, int(rng.randint(1, 256))):
            b = bytearray(data)
            b[i] ^= x
            yield bytes(b)


def damage_digest(outcomes) -> str:
    """SHA-256 over decode outcomes in turn: None (the decoder raised) as
    b"raise", an array as the SHA-256 of its bytes."""
    import hashlib

    h = hashlib.sha256()
    for px in outcomes:
        h.update(b"raise" if px is None else hashlib.sha256(
            np.ascontiguousarray(px).tobytes()).digest())
    return h.hexdigest()


def caption_case() -> tuple:
    """(image, boxes, labels, scores, class names) of CODEC_DIGESTS'
    "caption:overlay": ``demo.overlay_detections`` on a seeded photo with
    boxes at and past its edges, long and non-ASCII class names (some
    characters outside the font: ``.notdef``) and a label without a name."""
    img = codec_photo(80, 96, 160)
    boxes = np.array([[0, 0, 40, 30], [100, 2, 159, 60], [-6, 50, 30, 95],
                      [30, 10, 150, 90], [150, 80, 170, 100], [60, 95, 90, 95]],
                     np.float32)
    labels = np.array([1, 7, 42, 1593, 3, 9])
    scores = np.array([0.91, 0.5, 0.123, 0.05, 0.999, 0.5049], np.float32)
    names = {1: "person", 7: "a very long class name that runs off the image",
             42: "café crème – naïve", 1593: "中文 € ünïcødé", 3: "x,y;z"}
    return img, boxes, labels, scores, names


def codec_digests(fault: str | None = None) -> tuple:
    """(key → SHA-256 of the codec's output, key → host ms) for the decodes
    and encodes of CODEC_DIGESTS and the caption case, under one of
    CODEC_FAULTS if named (then only its format's: CODEC_FAULT_FILES; the
    caption case, ~0.2 s, only under a caption fault)."""
    import functools
    import hashlib
    from unittest import mock

    from cpt_tpu_torch.tools import demo
    from cpt_tpu_torch.utils import image_codec, text

    bit = image_codec.FAULTS.get(fault, 0) if fault else 0
    suffix = CODEC_FAULT_FILES[fault] if fault else None
    digests, ms = {}, {}
    if suffix in (None, ""):
        draw = functools.partial(text._draw_text,
                                 fault=text.FAULTS.get(fault, 0) if fault else 0)
        with mock.patch.object(text, "draw_text", draw):
            t = time.perf_counter()
            caption = demo.overlay_detections(*caption_case())
            ms["caption:overlay"] = (time.perf_counter() - t) * 1e3
        digests["caption:overlay"] = hashlib.sha256(caption.tobytes()).hexdigest()
    for path in codec_fixture_files():
        if suffix is not None and path.suffix != suffix:
            continue
        data = path.read_bytes()
        for mode in ("RGB", "L"):
            key = f"{path.name}:{mode}"
            t = time.perf_counter()
            try:      # a refusal is a digest that matches none
                out = image_codec._decode(data, mode, bit)
            except image_codec.ImageCodecError as e:
                digests[key] = f"refused: {e}"
                continue
            ms[key] = (time.perf_counter() - t) * 1e3
            digests[key] = hashlib.sha256(
                np.ascontiguousarray(out).tobytes()).hexdigest()
    if fault is None or fault in CODEC_DAMAGE_FAULTS:
        def decode(d):
            try:
                return image_codec._decode(d, "RGB", bit)
            except image_codec.ImageCodecError:
                return None

        t = time.perf_counter()
        for seed, name in enumerate(JPEG_DAMAGE_SOURCES):
            data = (CODEC_DIR / name).read_bytes()
            digests[f"damaged:{name}"] = damage_digest(
                decode(d) for d in jpeg_damaged(data, seed))
        ms["damaged"] = (time.perf_counter() - t) * 1e3
    # the encodes' inputs are drawn only for the runs that encode (~0.1 s
    # each: most faulted runs skip them)
    for name, (arr, quality) in (codec_encode_inputs().items()
                                 if suffix in (None, ".jpg") else ()):
        t = time.perf_counter()
        out = image_codec._encode_jpeg(arr, quality, bit)
        ms[f"encode:{name}"] = (time.perf_counter() - t) * 1e3
        digests[f"encode:{name}"] = hashlib.sha256(out).hexdigest()
    for name, arr in codec_tiff_encode_inputs().items() if suffix is None else ():
        t = time.perf_counter()
        out = image_codec.encode_tiff(arr)
        ms[f"encode_tiff:{name}"] = (time.perf_counter() - t) * 1e3
        digests[f"encode_tiff:{name}"] = hashlib.sha256(out).hexdigest()
    return digests, ms


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def codec_timing(reps: int = 20) -> dict:
    """The codec's host ms (median of ``reps`` calls) on the inputs of
    CODEC_PILLOW_MS."""
    from cpt_tpu_torch.utils import image_codec

    data = (CODEC_DIR / "baseline_420_q95_480x640.jpg").read_bytes()
    photo, q = codec_encode_inputs()["photo_q95"]
    out = {"decode_480x640_q95": median_ms(
               lambda: image_codec.decode(data), reps),
           "encode_480x640_q95": median_ms(
               lambda: image_codec.encode_jpeg(photo, q), reps)}
    for name in CODEC_JPEG_TIMED + CODEC_WEBP_TIMED + CODEC_TIFF_TIMED:
        data = (CODEC_DIR / name).read_bytes()
        out[name] = median_ms(lambda: image_codec.decode(data), reps)
    photo = codec_tiff_encode_inputs()["photo_rgb"]
    out["encode_tiff_480x640"] = median_ms(lambda: image_codec.encode_tiff(photo),
                                           reps)
    return out


def check_codec_digests() -> dict:
    """CODEC_DIGESTS against ``utils/image_codec`` here (the fixture
    decodes and the encodes; the validate_checkpoints fixture is checked in
    phase 21's run of the tool), each of CODEC_FAULTS changing one, and the
    codec's host ms beside Pillow's → readings; raises on a miss."""
    from cpt_tpu_torch.kernels import build

    t = time.perf_counter()
    got, ms = codec_digests()
    want = {k: v for k, v in CODEC_DIGESTS.items() if k in got}
    matched = {k: got.get(k) == v for k, v in want.items()}
    faults = {}
    for fault in CODEC_FAULTS:
        changed = codec_digests(fault)[0]
        faults[fault] = sorted(k for k in want if k in changed
                               and changed[k] != want[k])
    check_s = time.perf_counter() - t
    timing = codec_timing()
    print(f"image codec ({build.host_library_path().name}): "
          f"{sum(matched.values())} of {len(matched)} "
          f"digests equal Pillow 12.1's, in {check_s:.2f} s with the "
          f"{len(CODEC_FAULTS)} faulted runs; digests each named fault changes "
          f"{({k: len(v) for k, v in faults.items()})}; host ms here: decode "
          f"480x640 q95 {timing['decode_480x640_q95']:.2f}, encode 480x640 "
          f"q95 {timing['encode_480x640_q95']:.2f}; Pillow's on the CPU of "
          f"CODEC_PILLOW_MS {CODEC_PILLOW_MS['decode_480x640_q95']:.2f} and "
          f"{CODEC_PILLOW_MS['encode_480x640_q95']:.2f}; JPEG decodes at "
          f"480x640 (arithmetic progressive, lossless grey, smoothed), here / "
          f"Pillow's on that CPU: "
          + ", ".join(f"{n} {timing[n]:.2f} / {CODEC_PILLOW_MS[n]:.2f}"
                      for n in CODEC_JPEG_TIMED)
          + f"; the damaged JPEG corpora's {len(JPEG_DAMAGE_SOURCES)} digests "
          f"in {ms['damaged'] / 1e3:.2f} s; WEBP decodes at "
          f"480x640, here / Pillow's on that CPU: "
          + ", ".join(f"{n} {timing[n]:.2f} / {CODEC_PILLOW_MS[n]:.2f}"
                      for n in CODEC_WEBP_TIMED)
          + "; TIFF, here / Pillow's: "
          + ", ".join(f"{n} {timing[n]:.2f} / {CODEC_PILLOW_MS[n]:.2f}"
                      for n in CODEC_TIFF_TIMED + ("encode_tiff_480x640",)),
          flush=True)
    if (set(got) != set(want) or not all(matched.values())
            or not all(faults.values())):
        raise AssertionError(f"image codec digests: missing "
                             f"{sorted(set(got) - set(want))}, unmatched "
                             f"{[k for k, v in matched.items() if not v]}, "
                             f"faults {faults}")
    return {"matched": matched, "host_ms": ms, "faults": faults,
            "timing": timing, "seconds": check_s}


def jpeg_upload(img: np.ndarray) -> tuple:
    """(base64 of ``img`` as a quality-95 JPEG, the array it decodes to)."""
    from cpt_tpu_torch.utils import image_codec

    data = image_codec.encode_jpeg(img, 95)
    return base64.b64encode(data).decode(), image_codec.decode(data)


def http(port: int, path: str, body: bytes | None = None) -> tuple:
    """(status, json) of one request to the server on 127.0.0.1:``port``,
    with no proxy in the way."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body)
    try:
        with opener.open(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def same_pick(box, want_box, want_scores, dets) -> bool:
    """The same box as the reference's pick, unless the reference's top two
    scores are within SCORE_TOL (a tie at bf16 resolution): then the pick
    must score, by the reference, within SCORE_TOL of the reference's top.
    Scores follow the candidates' order ``dets``."""
    top2 = np.sort(np.asarray(want_scores))[-2:]
    if len(top2) < 2 or top2[1] - top2[0] > SCORE_TOL:
        return box == want_box
    return want_scores[dets.index(box)] >= max(want_scores) - SCORE_TOL


def run_serve(counters, smi: str, rows: list) -> dict:
    """Phase 8 (see the module docstring): the full-width grounding server
    (``tools/serve.py``; VinVL X152-C4 + Oscar-base, random weights from
    seed 0). Gathers every reading, prints it, then raises on the first
    check that failed."""
    import hashlib
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from cpt_tpu_torch.tools import cpt_predict as cp
    from cpt_tpu_torch.tools import serve
    from cpt_tpu_torch.utils import image_codec

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    digests = check_resize_digests()
    t0 = time.perf_counter()
    svc = serve.CPTService(serve.build_args().parse_args(
        ["--device", "cuda", "--no_warmup"]))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(2027)
    reqs = {n: serve_request(rng, n) for n in (8, 16)}
    for img, dets in reqs.values():             # each shape's first use
        svc.predict(img, SERVE_CAPTION, dets)
    zero_counts(counters)
    answers = {n: svc.predict(img, SERVE_CAPTION, dets)
               for n, (img, dets) in reqs.items()}
    launches = {k: fn.launches for k, fn in counters.items()}
    paths = k1_paths(counters, launches, "serve requests")
    # one scoring batch a request (8 and 16 sequences): 12 layers each
    want = {"K1": 100, "K2": 2, "K3": 24, "K4": 24, "K5": 0, "K6": 0,
            "K6b": 0, "K6c": 0, "K1q": 0, "K7": 0}
    check(launches == want, f"serve launches {launches}, want {want}")

    # against cpt_predict on the same image, caption, dets and weights
    vs_predict = {}
    with tempfile.TemporaryDirectory() as root:
        for n, (img, dets) in reqs.items():
            wd = f"{root}/{n}"
            box = cp.predict(svc.res, img, SERVE_CAPTION, dets, workdir=wd)
            want_scores = cp.candidate_scores(svc.res, wd)
            got_box, got_scores = answers[n]
            gap = float(np.abs(np.subtract(got_scores, want_scores)).max())
            vs_predict[n] = {"box": got_box, "predict_box": box,
                             "score_gap": gap}
            check(got_box in dets and same_pick(got_box, box, want_scores,
                                                dets)
                  and gap <= SCORE_TOL and len(got_scores) == n,
                  f"serve vs cpt_predict ({n} candidates): {vs_predict[n]}")

    # the two requests that take the resize rule (RESIZED_REQUESTS), each
    # against cpt_predict on the image as image_ops resizes it and the dets
    # scaled, as the server prepares them; K1 50, K2 1, K3 and K4 12 each
    resized, resized_launches = {}, {k: 0 for k in counters}
    for name in RESIZED_REQUESTS:
        img, dets = resized_request(name)
        zero_counts(counters)
        got_box, got_scores = svc.predict(img, SERVE_CAPTION, dets)
        ran = {k: fn.launches for k, fn in counters.items()}
        resized_launches = {k: resized_launches[k] + n for k, n in ran.items()}
        small, scale = svc._resize(img)
        sdets = (np.asarray(dets, np.float32) * scale).tolist()
        with tempfile.TemporaryDirectory() as wd:
            box = cp.predict(svc.res, small, SERVE_CAPTION, sdets, workdir=wd)
            want_scores = cp.candidate_scores(svc.res, wd)
        pick = int(np.abs(np.asarray(dets) - got_box).sum(1).argmin())
        want_pick = int(np.abs(np.asarray(sdets) - box).sum(1).argmin())
        gap = float(np.abs(np.subtract(got_scores, want_scores)).max())
        resized[name] = {"shape": list(img.shape[:2]), "scale": scale,
                         "resized": list(small.shape[:2]), "pick": pick,
                         "predict_pick": want_pick, "score_gap": gap,
                         "launches": ran}
        want = {"K1": 50, "K2": 1, "K3": 12, "K4": 12}
        check(same_pick(pick, want_pick, want_scores, list(range(len(dets))))
              and gap <= SCORE_TOL and len(got_scores) == len(dets)
              and small.shape[:2] == (600, 800),
              f"resized serve request {name} vs cpt_predict: {resized[name]}")
        check(all(ran[k] == n for k, n in want.items())
              and sum(ran.values()) == sum(want.values()),
              f"resized serve request {name} launches {ran}, want {want}")

    # HTTP on 127.0.0.1, on the server's handler threads; every image an
    # uploaded quality-95 JPEG, decoded by utils/image_codec in the handler
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    try:
        # the two resized requests as JPEG uploads: the decoded image is
        # Pillow's (CODEC_DIGESTS "upload:<name>"), the answer the direct
        # call's on it exactly (box and scores), K1 50, K2 1, K3 and K4 12
        # each; held to cpt_predict on the decoded array as the raw-array
        # requests are (its pick, scores within SCORE_TOL), and both bf16
        # paths each within SCORE_TOL of the f32 einsum path on
        # cpt_predict's features (one extractor, one image)
        oracle = rebuilt_scorer(svc.res, torch.float32,
                                attention_impl="einsum", ffn_impl="dense")
        uploads = {}
        for name in RESIZED_REQUESTS:
            img, dets = resized_request(name)
            b64, decoded = jpeg_upload(img)
            body = json.dumps({"image_b64": b64, "caption": SERVE_CAPTION,
                               "dets": dets}).encode()
            zero_counts(counters)
            status, answer = http(port, "/predict", body)
            ran = {k: fn.launches for k, fn in counters.items()}
            resized_launches = {k: resized_launches[k] + n
                                for k, n in ran.items()}
            direct = svc.predict(decoded, SERVE_CAPTION, dets)
            small, scale = svc._resize(decoded)
            sdets = (np.asarray(dets, np.float32) * scale).tolist()
            with tempfile.TemporaryDirectory() as wd:
                box = cp.predict(svc.res, small, SERVE_CAPTION, sdets,
                                 workdir=wd)
                want_scores = cp.candidate_scores(svc.res, wd)
                f32 = cp.candidate_scores(oracle, wd)
            digest = hashlib.sha256(decoded.tobytes()).hexdigest()
            pick_index = int(np.abs(np.asarray(dets) - direct[0]).sum(1)
                             .argmin())
            uploads[name] = {
                "status": status, "pick": answer.get("pred_box"),
                "direct_equal": (answer.get("pred_box") == direct[0]
                                 and answer.get("scores") == direct[1]),
                "decoded_is_pillows": digest == CODEC_DIGESTS[f"upload:{name}"],
                "predict_pick": int(np.abs(np.asarray(sdets) - box).sum(1)
                                    .argmin()),
                "pick_index": pick_index, "f32_pick": int(np.argmax(f32)),
                "predict_gap": float(np.abs(np.subtract(
                    direct[1], want_scores)).max()),
                "served_f32_gap": float(np.abs(np.subtract(direct[1],
                                                           f32)).max()),
                "predict_f32_gap": float(np.abs(np.subtract(want_scores,
                                                            f32)).max()),
                "launches": ran}
            want = {"K1": 50, "K2": 1, "K3": 12, "K4": 12}
            up = uploads[name]
            check(status == 200 and up["direct_equal"]
                  and up["decoded_is_pillows"]
                  and same_pick(pick_index, up["predict_pick"], want_scores,
                                list(range(len(dets))))
                  and up["predict_gap"] <= SCORE_TOL
                  and up["served_f32_gap"] <= SCORE_TOL
                  and up["predict_f32_gap"] <= SCORE_TOL
                  and same_pick(pick_index, up["f32_pick"], f32,
                                list(range(len(dets)))),
                  f"JPEG upload {name}: {up}")
            check(all(ran[k] == n for k, n in want.items())
                  and sum(ran.values()) == sum(want.values()),
                  f"JPEG upload {name} launches {ran}, want {want}")

        del oracle
        # one lossy-with-alpha WEBP upload (WEBP_UPLOAD) and one YCbCr-JPEG
        # TIFF upload (TIFF_UPLOAD), committed fixtures (the card's host has
        # no writer of either): each decode is Pillow's (CODEC_DIGESTS), the
        # served answer the direct call's on it exactly, K1 50, K2 1, K3 and
        # K4 12 (each takes the resize rule)
        file_uploads = {}
        for kind, name, seed in (("WEBP", WEBP_UPLOAD, 2038),
                                 ("TIFF", TIFF_UPLOAD, 2039)):
            fdata = (CODEC_DIR / name).read_bytes()
            fdecoded = image_codec.decode(fdata)
            fdets = serve_request(np.random.RandomState(seed), 8,
                                  *fdecoded.shape[:2], 300)[1]
            zero_counts(counters)
            status, answer = http(port, "/predict", json.dumps({
                "image_b64": base64.b64encode(fdata).decode(),
                "caption": SERVE_CAPTION, "dets": fdets}).encode())
            ran = {k: fn.launches for k, fn in counters.items()}
            resized_launches = {k: resized_launches[k] + n for k, n in ran.items()}
            direct = svc.predict(fdecoded, SERVE_CAPTION, fdets)
            up = file_uploads[kind] = {
                "file": name, "status": status, "pick": answer.get("pred_box"),
                "direct_equal": (answer.get("pred_box") == direct[0]
                                 and answer.get("scores") == direct[1]),
                "decoded_is_pillows": hashlib.sha256(fdecoded.tobytes()).hexdigest()
                == CODEC_DIGESTS[f"{name}:RGB"], "launches": ran}
            want = {"K1": 50, "K2": 1, "K3": 12, "K4": 12}
            check(status == 200 and up["direct_equal"]
                  and up["decoded_is_pillows"] and direct[0] in fdets,
                  f"{kind} upload: {up}")
            check(all(ran[k] == n for k, n in want.items())
                  and sum(ran.values()) == sum(want.values()),
                  f"{kind} upload launches {ran}, want {want}")

        img8, dets8 = reqs[8]
        b64_8, decoded8 = jpeg_upload(img8)
        direct8 = svc.predict(decoded8, SERVE_CAPTION, dets8)
        body8 = json.dumps({"image_b64": b64_8, "caption": SERVE_CAPTION,
                            "dets": dets8}).encode()
        # grad mode is per thread: each output of both models during a
        # request answered on a handler thread must be an inference tensor
        outputs = {"oscar": [], "backbone": []}

        def hook(name):
            def record(_module, _inputs, out):
                outputs[name].extend(
                    (t.is_inference(), t.requires_grad)
                    for t in (out if isinstance(out, tuple) else (out,))
                    if isinstance(t, torch.Tensor))
            return record

        hooked = {"oscar": svc.res.oscar, "backbone": svc.res.detector.backbone}
        health = http(port, "/healthz")
        unknown = http(port, "/unknown")
        too_many = http(port, "/predict", json.dumps({
            "image_b64": b64_8, "caption": SERVE_CAPTION,
            "dets": [[1, 1, 20, 20]] * (serve.MAX_REQUEST_DETS + 1)}).encode())
        handles = [m.register_forward_hook(hook(n)) for n, m in hooked.items()]
        try:
            first = http(port, "/predict", body8)
        finally:
            for h in handles:
                h.remove()
        torch.cuda.synchronize()
        mem = [torch.cuda.memory_allocated()]
        for _ in range(9):
            http(port, "/predict", body8)
        torch.cuda.synchronize()
        mem.append(torch.cuda.memory_allocated())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    http_gap = (float(np.abs(np.subtract(first[1]["scores"], direct8[1])).max())
                if first[0] == 200 else None)
    check(health[0] == 200 and health[1].get("device") == "cuda",
          f"/healthz {health}")
    check(unknown[0] == 404, f"unknown path {unknown}")
    check(too_many[0] == 400 and "too many candidate dets"
          in too_many[1].get("error", ""), f"129 dets {too_many}")
    check(first[0] == 200 and first[1]["pred_box"] == direct8[0]
          and http_gap <= SCORE_TOL, f"HTTP predict {first}, gap {http_gap}")
    params = [p for m in (svc.res.oscar, svc.res.detector) for p in m.parameters()]
    grad_mode = {n: {"outputs": len(o), "inference": sum(i for i, _ in o),
                     "requires_grad": sum(r for _, r in o)}
                 for n, o in outputs.items()}
    grad_mode["params_requiring_grad"] = sum(p.requires_grad for p in params)
    grad_mode["params_with_grad"] = sum(p.grad is not None for p in params)
    check(all(g["outputs"] > 0 and g["inference"] == g["outputs"]
              and g["requires_grad"] == 0
              for g in (grad_mode["oscar"], grad_mode["backbone"]))
          and grad_mode["params_requiring_grad"] > 0
          and grad_mode["params_with_grad"] == 0,
          f"grad mode on the handler thread {grad_mode}")
    # and no memory kept from one request to the next
    check(abs(mem[1] - mem[0]) <= 0.01 * mem[0],
          f"allocated bytes after 1 and 10 HTTP requests {mem}")

    # K3 at the smallest bucket: 8 sequences of 70 text + 8 region slots
    check_k3(rows, 8, 78)

    host_ms = {}
    timed = dict(reqs, **{name: resized_request(name) for name in RESIZED_REQUESTS})
    for n, (img, dets) in timed.items():
        ms = []
        for _ in range(5):
            t = time.perf_counter()
            svc.predict(img, SERVE_CAPTION, dets)
            ms.append((time.perf_counter() - t) * 1e3)
        host_ms[n] = ms
    # device time of an 8-candidate request at 600x800 and of the two
    # resized ones (the resize is host work)
    resized_profiles = {n: profiled(
        lambda n=n: svc.predict(timed[n][0], SERVE_CAPTION, timed[n][1]),
        f"serve request {n} ({timed[n][0].shape[0]}x{timed[n][0].shape[1]})")
        for n in (8, *RESIZED_REQUESTS)}
    before = {k: counters[k].launches for k in ("K3", "K4")}
    img16, dets16 = reqs[16]
    prof = profiled(lambda: svc.predict(img16, SERVE_CAPTION, dets16),
                    "serve request (16 candidates)")
    check_gemm_group(prof["groups"], {k: counters[k].launches - n
                                      for k, n in before.items()},
                     "the profiled serve request")
    del svc
    torch.cuda.empty_cache()

    # --windowed --base_batch 4: 4 requests queued together drain as one
    # batched base pass; a fifth request holds the worker in its host prep
    # until they are queued
    wsvc = serve.CPTService(serve.build_args().parse_args(
        ["--device", "cuda", "--no_warmup", "--windowed", "--base_batch", "4"]))
    wreqs = [serve_request(rng, 8) for _ in range(4)]
    wsvc.predict(wreqs[0][0], SERVE_CAPTION, wreqs[0][1])
    serial = [wsvc.predict(img, SERVE_CAPTION, dets) for img, dets in wreqs]
    entered, gate = threading.Event(), threading.Event()
    prepare = wsvc._prepare

    def gated(img, caption, dets):
        if caption == "gate":
            entered.set()
            gate.wait(300)
        return prepare(img, caption, dets)

    wsvc._prepare = gated
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        held = ex.submit(wsvc.predict, wreqs[0][0], "gate", wreqs[0][1])
        entered.wait(300)
        futs = [ex.submit(wsvc.predict, img, SERVE_CAPTION, dets)
                for img, dets in wreqs]
        for _ in range(3000):
            if wsvc.batcher.q.qsize() == len(wreqs):
                break
            time.sleep(0.01)
        gate.set()
        together = [f.result(timeout=300) for f in futs]
        held.result(timeout=300)
    stats = {k: list(v) for k, v in wsvc.batcher.stats.items()}
    batch_gap = max(float(np.abs(np.subtract(a[1], b[1])).max())
                    for a, b in zip(serial, together))
    serial_s = sum(stats["base_s"][1:5]) + sum(stats["finish_s"][1:5])
    batched_s = stats["base_s"][-1] + stats["finish_s"][-1]
    check(stats["drains"] == [1, 1, 1, 1, 1, 1, 4],
          f"batcher drains {stats['drains']}")
    check(all(a[0] == b[0] for a, b in zip(serial, together))
          and batch_gap <= SCORE_TOL,
          f"batched vs serial: boxes {[(a[0], b[0]) for a, b in zip(serial, together)]}, "
          f"gap {batch_gap}")
    check(wsvc.extractor.windowed_mode == "two_level",
          f"windowed mode {wsvc.extractor.windowed_mode}")
    del wsvc
    torch.cuda.empty_cache()

    print(f"phase 8 serve ({smi}): service built in {build_s:.1f} s; launches "
          f"over an 8- and a 16-candidate request {launches} (K1 by path "
          f"{paths}); vs cpt_predict "
          + ", ".join(f"{n} candidates box {v['box']} (predict {v['predict_box']}) "
                      f"score gap {v['score_gap']:.3e}" for n, v in vs_predict.items())
          + f" (SCORE_TOL {SCORE_TOL}); HTTP /healthz {health[1]}, 129 dets -> "
          f"{too_many[0]}, unknown path -> {unknown[0]}, predict -> {first[0]} "
          f"(gap to the direct call {http_gap}), grad mode on its handler "
          f"thread {grad_mode}; allocated bytes after 1 and 10 "
          f"HTTP requests {mem}; host ms per request, warm: 8 candidates "
          f"{[round(x, 2) for x in host_ms[8]]}, 16 candidates "
          f"{[round(x, 2) for x in host_ms[16]]}; resized requests "
          + ", ".join(f"{n} {v['shape'][0]}x{v['shape'][1]} -> "
                      f"{v['resized'][0]}x{v['resized'][1]} (scale {v['scale']}): "
                      f"pick {v['pick']} (predict {v['predict_pick']}), score "
                      f"gap {v['score_gap']:.3e}, launches {v['launches']}, host "
                      f"ms {[round(x, 2) for x in host_ms[n]]}"
                      for n, v in resized.items())
          + "; JPEG uploads (quality 95) "
          + ", ".join(f"{n}: decoded as Pillow {v['decoded_is_pillows']}, "
                      f"answer equal to the direct call's "
                      f"{v['direct_equal']}, pick {v['pick_index']} "
                      f"(cpt_predict {v['predict_pick']}, f32 {v['f32_pick']}),"
                      f" score gaps to f32 {v['served_f32_gap']:.3e} served, "
                      f"{v['predict_f32_gap']:.3e} cpt_predict, to each other "
                      f"{v['predict_gap']:.3e}, launches {v['launches']}"
                      for n, v in uploads.items())
          + "".join(f"; {k} upload {v['file']}: decoded as Pillow "
                    f"{v['decoded_is_pillows']}, answer equal to the direct "
                    f"call's {v['direct_equal']}, launches {v['launches']}"
                    for k, v in file_uploads.items())
          + "; profiled host / device ms: "
          + ", ".join(f"{n} {p['ms']:.2f} / {p['device_ms']:.2f}"
                      for n, p in resized_profiles.items())
          + f"; windowed --base_batch 4: "
          f"drains {stats['drains']}, 4 requests in {batched_s * 1e3:.1f} ms "
          f"of base + finish batched ({4 / batched_s:.2f} requests/s) against "
          f"{serial_s * 1e3:.1f} ms serial ({4 / serial_s:.2f} requests/s); "
          f"largest batched-vs-serial score gap {batch_gap:.3e}", flush=True)
    if failed:
        raise AssertionError(f"phase 8: {failed}")
    return {"build_s": build_s, "launches": launches, "k1_paths": paths,
            "vs_predict": vs_predict, "health": health[1], "memory": mem,
            "grad_mode": grad_mode, "digests": digests,
            "resized": resized, "resized_launches": resized_launches,
            "uploads": uploads, "file_uploads": file_uploads,
            "resized_profiles": resized_profiles,
            "host_ms": host_ms, "profile": prof,
            "base_batch": {"drains": stats["drains"], "serial_s": serial_s,
                           "batched_s": batched_s,
                           "requests_per_s": 4 / batched_s,
                           "serial_requests_per_s": 4 / serial_s,
                           "score_gap": batch_gap}}


# Phase 9: VCR. Entity names of the 10 boxes of the VCR image; members 1
# and 5 share a box, so the paint's dedup by box value skips member 5.
VCR_NAMES = ("person", "person", "dog", "cat", "person", "person", "dog",
             "man", "woman", "cat")
# Named faults of NSP scoring that the zero-shot check must catch: the
# pooler reading the last position instead of [CLS], and text_b's segment
# ids set to 0. A twin-head run must also catch the other head's scores.
VCR_FAULTS = ("pooler_last_token", "segment_ids_zero")
# Phase 9's zero-shot scores, bf16 against the f32 einsum path on the same
# features and the weights rounded to bf16, as an absolute limit on each
# candidate's score. An NSP score is a probability, 1 − softmax(logits)[1],
# and with these random weights the scores sit at 0.48-0.50, so bf16 moves
# them far less than the MLM ratios of SCORE_TOL: sound runs of this
# phase on the H100 80GB HBM3 at 700 W (4 questions; q->a, qa->r, q->ar)
# read gaps of 1.517e-3 to 2.812e-3. 6e-3 is 2.13x the largest. At SCORE_TOL
# (4e-2) text_b's segment ids set to 0 passed (9.461e-3 to 1.531e-2) and so
# did the pooler on the last position for q->a (3.532e-2): the check could
# not fail. Both miss 6e-3 by 1.6x or more, and a twin run scored with its
# other head by 5.9x or more.
VCR_SCORE_TOL = 6e-3


def vcr_questions(rng, n: int = 4, h: int = 600, w: int = 800) -> tuple:
    """``n`` VCR questions on one h×w image: 10 entity boxes with numpy-drawn
    elliptic masks, painted in 3 colors (``color_d`` 3) through
    ``stage1_tasks.vcr_color_task_from_masks`` → (tasks, examples)."""
    from cpt_tpu_torch.data.stage1_tasks import (vcr_color_task_from_masks,
                                                 vcr_entity_groups)

    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, 500, (10, 2))
    wh = rng.uniform(40, 280, (10, 2))
    boxes = np.round(np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1))
    boxes[5] = boxes[1]
    yy, xx = np.mgrid[:h, :w]
    masks = {}
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        masks[i] = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1).astype(np.uint8)
    names = dict(enumerate(VCR_NAMES))
    words = ("left", "right", "red", "dog", "man", "woman")
    tasks, examples = [], []
    for q in range(n):
        g = [[q % 10], [1, 5], [(q + 2) % 10], [(q + 3) % 10, (q + 4) % 10]]
        ann = {"question": ["what", "is", g[0], "on", "the", "left", "of",
                            g[1], "?"],
               "answers": [[g[2 + c % 2], "is", "on", "the", words[c]]
                           for c in range(4)],
               "rationales": [[g[c % 2], "is", "in", "the", words[c + 2], "of",
                               g[3]] for c in range(4)]}
        vis, txt = vcr_entity_groups(ann)
        task = vcr_color_task_from_masks(f"vcr{q}", img, (h, w), boxes, vis,
                                         masks, names, color_d=3,
                                         txt_entity_ids=txt)
        tasks.append(task)
        examples.append({"q_id": f"q{q}", "img_key": task.key,
                         "question": ann["question"], "choices": ann["answers"],
                         "label": q % 4, "rationale_choices": ann["rationales"],
                         "rationale_label": (q + 1) % 4})
    return tasks, examples


@contextlib.contextmanager
def vcr_fault(fault: str, data):
    """NSP scoring of ``data`` with one of VCR_FAULTS."""
    import torch

    from cpt_tpu_torch.models.bert import model

    real_pooler, real_batch = model.BertPooler.forward, data.batch
    if fault == "pooler_last_token":
        model.BertPooler.forward = lambda self, seq: torch.tanh(
            self.dense(seq[:, -1]))
    elif fault == "segment_ids_zero":
        def batch(*a, **kw):
            b, labels, meta = real_batch(*a, **kw)
            b.segment_ids[:] = 0
            return b, labels, meta
        data.batch = batch
    else:
        raise ValueError(f"unknown VCR fault {fault!r}")
    try:
        yield
    finally:
        model.BertPooler.forward = real_pooler
        data.batch = real_batch


def split_qkv(grads: dict) -> dict:
    """``grads`` with each layer's packed ``wqkv`` gradient as three tensors
    (its q, k and v columns): a relative gap over the packed tensor hides a
    gradient of one of them that is wrong or missing."""
    out = {}
    for name, g in grads.items():
        if name.endswith("attention.wqkv"):
            for part, t in zip("qkv", g.chunk(3, -1)):
                out[f"{name}.{part}"] = t
        else:
            out[name] = g
    return out


def run_vcr_polygons(counters, device: str, dtype: str,
                     tiny: bool = False) -> dict:
    """``extract_features --task vcr`` over ``vcr_polygon_fixture`` (the
    ``img_key`` layout, its image a quality-95 JPEG),
    then the same run with each question's masks drawn by
    ``image_ops.fill_polygon`` and painted through
    ``vcr_color_task_from_masks`` → readings: whether the two TSVs are
    equal byte for byte, the polygon run's launches and rows. ``tiny``:
    the tiny detector (a dry run on the CPU)."""
    from cpt_tpu_torch.data import stage1_tasks
    from cpt_tpu_torch.tools import extract_features
    from cpt_tpu_torch.utils.image_codec import write_image
    from cpt_tpu_torch.utils.image_ops import fill_polygon
    from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature

    fx = vcr_polygon_fixture()
    real = stage1_tasks.vcr_color_task

    def from_masks(q_id, image_rgb, image_hw, det_boxes, entity_ids,
                   entity_polygons, entity_names, color_d=6, *a, **kw):
        h, w = image_rgb.shape[:2]
        masks = {i: fill_polygon(entity_polygons.get(i, []), h, w)
                 for ids in entity_ids for i in ids}
        return stage1_tasks.vcr_color_task_from_masks(
            q_id, image_rgb, image_hw, det_boxes, entity_ids, masks,
            entity_names, color_d, *a, **kw)

    with tempfile.TemporaryDirectory() as root:
        write_image(f"{root}/vcr.jpg", fx["image"], quality=95)
        anns = [dict(q, entity_polygons={str(i): p for i, p in fx["polygons"].items()},
                     entity_names={str(i): n for i, n in enumerate(fx["names"])})
                for q in fx["questions"]]
        dets = {q["img_key"]: [{"box": [x1, y1, x2 - x1 + 1, y2 - y1 + 1]}
                               for x1, y1, x2, y2 in fx["boxes"]]
                for q in fx["questions"]}
        for name, obj in (("ann", anns), ("det", dets)):
            with open(f"{root}/{name}.json", "w") as f:
                json.dump(obj, f)
        flags = ["--task", "vcr", "--ann_file", f"{root}/ann.json",
                 "--det_file", f"{root}/det.json", "--image_root", root,
                 "--color_d", "3", "--device", device, "--dtype", dtype]
        flags += ["--tiny"] if tiny else []
        zero_counts(counters)
        t = time.perf_counter()
        extract_features.main(flags + ["--output", f"{root}/polygons.tsv"])
        seconds = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        stage1_tasks.vcr_color_task = from_masks
        try:
            extract_features.main(flags + ["--output", f"{root}/masks.tsv"])
        finally:
            stage1_tasks.vcr_color_task = real
        with open(f"{root}/polygons.tsv", "rb") as a, open(f"{root}/masks.tsv",
                                                           "rb") as b:
            equal = a.read() == b.read()
        tsv = TSVFile(f"{root}/polygons.tsv")
        rows = [json.loads(tsv.seek(i)[1])["objects"] for i in range(len(tsv))]
        tsv.close()
    feats = [decode_feature(b["feature"]) for objs, _meta in rows for b in objs]
    return {"equal": equal, "rows": len(rows), "seconds": seconds,
            "colored": [meta[0] for _objs, meta in rows],
            "finite": bool(feats) and all(np.isfinite(f).all() for f in feats),
            "launches": launches}


def run_vcr(res, counters, smi: str, rows: list) -> dict:
    """Phase 9 (see the module docstring) on phase 4's detector. Gathers
    every reading, prints it, then raises on the first check that failed."""
    import torch

    from cpt_tpu_torch.data.vcr import VCRCPTData, load_vcr_examples
    from cpt_tpu_torch.engine.extract import vcr_payload
    from cpt_tpu_torch.models.bert.heads import NSPCPT, VCRQAR_NSPCPT
    from cpt_tpu_torch.tools import grad_gap
    from cpt_tpu_torch.tools import vcr_nsp_cpt as tool
    from cpt_tpu_torch.utils import convert as cv

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    # the kernels at the VCR shapes: an eval batch of 8 questions × 4
    # candidates, 80 text + 60 region slots (K3's streamed core above 128);
    # the training batch of 4 × 4 under "flash"
    check_k3(rows, 32, 140)
    check_k4(rows, 32 * 140)
    check_flash(rows, [(16, 12, 140, "key")])
    check_flash_bwd(rows, [(16, 12, 140, "key")])

    dev, bf = res.device, torch.bfloat16
    tasks, examples = vcr_questions(np.random.RandomState(2028))
    out = {}
    with tempfile.TemporaryDirectory() as root:
        tsv, ex_path = f"{root}/predictions.tsv", f"{root}/examples.json"
        zero_counts(counters)
        t0 = time.perf_counter()
        res.extractor.run(tasks, tsv, payload_fn=vcr_payload)
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        stage1 = {k: fn.launches for k, fn in counters.items()}
        with open(ex_path, "w") as f:
            json.dump(examples, f)
        check(stage1["K1"] == 50 * len(tasks) and stage1["K2"] == len(tasks),
              f"stage-1 launches {stage1}")
        meta = [t.meta for t in tasks]
        check(all("5" not in m["obj_colors"] and "1_5" not in m["obj_colors"]
                  for m in meta) and all(len(set(m["obj_colors"].values())) <= 3
                                         for m in meta),
              f"stage-1 colors {meta}")

        # the same stage 1 from polygons, through extract_features --task vcr
        poly = run_vcr_polygons(counters, dev.type, "bfloat16")
        n_q = len(vcr_polygon_fixture()["questions"])
        check(poly["equal"] and poly["rows"] == n_q and poly["finite"]
              and all(poly["colored"]),
              f"extract_features --task vcr from polygons: {poly}")
        check(poly["launches"]["K1"] == 50 * n_q and poly["launches"]["K2"] == n_q,
              f"extract_features --task vcr from polygons: launches "
              f"{poly['launches']}")
        out["polygons"] = poly

        # zero-shot: NSPCPT (q->a, qa->r) and VCRQAR_NSPCPT (q->ar) from one
        # seeded Oscar-layout state dict; the twin's "rat" kernel is drawn
        # anew at the scale of the NSP head's, so that the two heads differ
        # and their scores sit in the same range. Each run is
        # held to an NSPCPT on the f32 einsum path that carries the head the
        # run should read, on the same weights rounded to bf16: a twin run
        # that read the other head misses it (fault "head_swapped").
        dim = res.bert_cfg.img_feature_dim
        cfg = tool.model_config(tool.build_args().parse_args(
            ["--feat_file", tsv, "--examples", ex_path, "--img_feature_dim",
             str(dim)]))
        sd = cv.random_oscar_state_dict(cfg, seed=0)
        states = {cls: cv.state_from_reference(sd, cfg, cls.TASK)
                  for cls in (NSPCPT, VCRQAR_NSPCPT)}
        twin = states[VCRQAR_NSPCPT]
        rat = twin["cls_rat.dense.kernel"]
        twin["cls_rat.dense.kernel"] = float(rat.std()) * torch.from_numpy(
            np.random.RandomState(1).randn(*rat.shape).astype(np.float32))

        def build(cls, dtype, state, **changes):
            with torch.device(dev):
                model = cls(dataclasses.replace(cfg, **changes), dtype).eval()
            model.load_state_dict(state)
            if dtype == torch.float32:
                model.load_state_dict({k: v.to(bf).float() if v.dim() > 1 else v
                                       for k, v in model.state_dict().items()})
            return model

        def nsp_with(head):
            """The twin's state as NSPCPT's, ``head`` as its NSP head."""
            out = {k: v for k, v in twin.items() if not k.startswith("cls_")}
            out.update({"nsp_head." + k.split(".", 1)[1]: v
                        for k, v in twin.items() if k.startswith(f"cls_{head}.")})
            return out

        runs = (("qa", NSPCPT, None, False), ("qar_r", NSPCPT, None, True),
                ("qar ans", VCRQAR_NSPCPT, "ans", False),
                ("qar rat", VCRQAR_NSPCPT, "rat", True))
        models = {cls: build(cls, bf, states[cls]) for cls in (NSPCPT, VCRQAR_NSPCPT)}
        oracles = {head: build(NSPCPT, torch.float32,
                               states[NSPCPT] if head is None else nsp_with(head),
                               attention_impl="einsum", ffn_impl="dense")
                   for head in (None, "ans", "rat")}
        zs = {}
        launches = dict(stage1)
        data = VCRCPTData(tsv, load_vcr_examples(ex_path), res.tokenizer, 80,
                          60, dim)

        def flat(results):
            return np.asarray([s for q in sorted(results)
                               for s in results[q]["scores"]])

        for name, cls, head, rat in runs:
            model = models[cls]
            zero_counts(counters)
            t = time.perf_counter()
            acc, got = tool.run_eval(model, data, 8, head=head,
                                     use_rationale=rat)
            ms = (time.perf_counter() - t) * 1e3
            ran = {k: fn.launches for k, fn in counters.items()}
            launches = {k: launches[k] + n for k, n in ran.items()}
            want = flat(tool.run_eval(oracles[head], data, 8,
                                      use_rationale=rat)[1])
            gap = float(np.abs(flat(got) - want).max())

            def fault_gap(h):
                return float(np.abs(flat(tool.run_eval(
                    model, data, 8, head=h, use_rationale=rat)[1]) - want).max())

            fault_gaps = {}
            for fault in VCR_FAULTS:
                with vcr_fault(fault, data):
                    fault_gaps[fault] = fault_gap(head)
            if head is not None:
                fault_gaps["head_swapped"] = fault_gap(
                    {"ans": "rat", "rat": "ans"}[head])
            zs[name] = {"accuracy": acc, "ms": ms, "gap": gap,
                        "fault_gaps": fault_gaps, "launches": ran,
                        "score_range": [float(flat(got).min()),
                                        float(flat(got).max())]}
            check(ran["K3"] == 12 and ran["K4"] == 12
                  and gap <= VCR_SCORE_TOL and len(flat(got)) == 4 * len(tasks),
                  f"zero-shot {name}: launches {ran}, gap {gap}")
            check(all(e > VCR_SCORE_TOL for e in fault_gaps.values()),
                  f"zero-shot {name}: a fault passes {fault_gaps}")
        data.tsv.close()
        del models, oracles
        out["zero_shot"] = zs
        out["launches"] = launches

        # prompt tuning under "flash" (attention dropout 0): TUNING_STEPS
        # steps of 4 questions x 4 candidates through the tool's loop
        args = tool.build_args().parse_args(
            ["--feat_file", tsv, "--examples", ex_path, "--num_train_epochs",
             str(TUNING_STEPS), "--per_gpu_train_batch_size", "4", "--seed", "0",
             "--img_feature_dim", str(dim)])
        data = VCRCPTData(tsv, load_vcr_examples(ex_path), res.tokenizer,
                          80, 60, dim)
        model = build(NSPCPT, bf, states[NSPCPT], **grad_gap.FLASH)
        steps = []
        mark = [time.perf_counter(), {k: 0 for k in counters}]

        def on_step(step, loss):
            now = time.perf_counter()
            seen = {k: fn.launches for k, fn in counters.items()}
            steps.append({"step": step, "loss": loss, "ms": (now - mark[0]) * 1e3,
                          "launches": {k: seen[k] - mark[1][k] for k in seen}})
            mark[:] = [now, seen]

        zero_counts(counters)
        mark[0] = time.perf_counter()
        losses = tool.train(model, data, args, dev, on_step)
        train_launches = {k: fn.launches for k, fn in counters.items()}
        data.tsv.close()
    steady = [st["ms"] for st in steps[1:]]
    want_step = {"K6": 12, "K6b": 12, "K6c": 12, "K3": 0, "K4": 0}
    bad = [st for st in steps
           if any(st["launches"][k] != n for k, n in want_step.items())]
    check(len(losses) == TUNING_STEPS and np.isfinite(losses).all() and not bad,
          f"VCR training: losses {losses}, steps off their counts {bad[:2]}")

    # one step's gradients against the f32 einsum path, dropout off, on a
    # synthetic VCR-shaped batch (16 sequences, 80 + 60 slots), per
    # q / k / v column block of each wqkv
    state = states[NSPCPT]
    batch = grad_gap.nsp_batch(cfg, 16, 0, dev)
    _, ref = grad_gap.step_grads(grad_gap.build(state, cfg, torch.float32, dev,
                                                NSPCPT, **grad_gap.PLAIN), batch)
    ref = split_qkv(ref)
    flash = grad_gap.build(state, cfg, bf, dev, NSPCPT, **grad_gap.FLASH)
    plain16 = grad_gap.build(state, cfg, bf, dev, NSPCPT, **grad_gap.PLAIN)
    gaps = {"flash": grad_gap.gap(split_qkv(grad_gap.step_grads(flash, batch)[1]), ref),
            "plain_bf16": grad_gap.gap(
                split_qkv(grad_gap.step_grads(plain16, batch)[1]), ref)}
    with grad_gap.zeroed_dk():
        gaps["flash_dk_zeroed"] = grad_gap.gap(
            split_qkv(grad_gap.step_grads(flash, batch)[1]), ref)
    check(gaps["flash"][0] <= GRAD_TOL < gaps["flash_dk_zeroed"][0],
          f"VCR gradient check {gaps}")
    del flash, plain16, ref

    print(f"phase 9 VCR ({smi}): stage 1, {len(tasks)} questions on a 600x800 "
          f"image in {extract_s * 1e3:.1f} ms, launches {stage1}; "
          f"extract_features --task vcr from polygons ({out['polygons']['rows']} "
          f"questions, {out['polygons']['seconds']:.2f} s with set-up): TSV equal "
          f"to the from-masks path byte for byte: {out['polygons']['equal']}, "
          f"launches {out['polygons']['launches']}; zero-shot "
          + "; ".join(f"{k}: gap to f32 {v['gap']:.3e}, faults "
                      + ", ".join(f"{f} {e:.3e} ({e / VCR_SCORE_TOL:.1f}x tol)"
                                  for f, e in v["fault_gaps"].items())
                      + f", scores {v['score_range'][0]:.4f}..{v['score_range'][1]:.4f}"
                      f", {v['ms']:.1f} ms" for k, v in zs.items())
          + f" (VCR_SCORE_TOL {VCR_SCORE_TOL}); training (flash, 4x4 "
          f"sequences, 80 + 60 slots): {len(losses)} steps, ms/step {np.mean(steady):.2f} after "
          f"the first ({steps[0]['ms']:.1f}), losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, launches {train_launches}; gradients vs f32 "
          f"einsum (largest per-tensor relative L2, wqkv by q/k/v) "
          + ", ".join(f"{k} {v[0]:.4e} ({v[1]})" for k, v in gaps.items())
          + f"; GRAD_TOL {GRAD_TOL}", flush=True)
    if failed:
        raise AssertionError(f"phase 9: {failed}")
    out.update({"extract_ms": extract_s * 1e3, "stage1_launches": stage1,
                "train": {"losses": losses, "steps": steps,
                          "ms_per_step": float(np.mean(steady)),
                          "launches": train_launches},
                "gradient_gaps": gaps})
    return out


# Phase 10: the other CPT tasks (GQA, VG relations, RefCOCO SEG) on phase
# 4's detector and Oscar-base. Class names of the labelmap the stage-1
# extractors write into the TSVs: words of the resident's vocabulary on
# every sixth label, "thing<i>" (an unknown word) on the others.
TASK_WORDS = ("man", "woman", "dog", "cat", "person", "people")
GQA_ANSWERS = ("red", "blue", "green", "yellow", "purple", "pink", "gray",
               "brown", "left", "right")
# the 50 predicates of VG's relation split (VG-SGG-dicts.json)
VG_PREDICATES = (
    "above", "across", "against", "along", "and", "at", "attached to",
    "behind", "belonging to", "between", "carrying", "covered in", "covering",
    "eating", "flying in", "for", "from", "growing on", "hanging from", "has",
    "holding", "in", "in front of", "laying on", "looking at", "lying on",
    "made of", "mounted on", "near", "of", "on", "on back of", "over",
    "painted on", "parked on", "part of", "playing", "riding", "says",
    "sitting on", "standing on", "to", "under", "using", "walking in",
    "walking on", "watching", "wearing", "wears", "with")
# Named faults of phase 10's scoring, each of which its tolerance must see:
# GQA's question scored without its color rewrite, its [MASK] read one
# position late, its [CLS] in segment 0 (the reference puts it in 1); VG's
# two pair directions swapped and a width-k predicate read from the width
# k + 1 sequence. VG's third, the subject and object colors swapped in
# stage 1, moves the scores less than bf16 does (below), so stage 1's paint
# is held bit for bit instead (``host_painted_features``).
GQA_FAULTS = ("rewrite_dropped", "mask_pos_shifted", "cls_segment_0")
VG_FAULTS = ("directions_swapped", "width_off_by_one")
# Phase 10's zero-shot scores, bf16 against the f32 einsum path on the same
# features and the weights rounded to bf16, as the mean |Δ| over every
# score (GQA: 8 questions × 10 answer logits; VG: 32 keys × 50 predicate
# mean log-probabilities). The first card run (H100 80GB HBM3, 700 W;
# deterministic, a second run read the same) gave bf16 gaps of 6.6e-3
# (GQA) and 7.7e-3 (VG) and, of the faults, 1.75e-2 (cls_segment_0) to
# 0.41 (GQA) and 1.96e-2 (directions_swapped) to 4.3e-2 (VG). The largest
# |Δ| separates them less: bf16 2.2e-2 against cls_segment_0's 4.3e-2, and
# VG's bf16 5.0e-2 against directions_swapped's 7.6e-2 (both printed). The
# colors swapped in VG's stage 1 moved the scores by 9.2e-3 (mean) and
# 3.9e-2 (largest), inside bf16's own gap: no score tolerance can see it.
# Each tolerance is the geometric mean of the bf16 gap and the smallest
# fault's, 1.6x from each.
GQA_SCORE_TOL = 1.1e-2
VG_LOGPROB_TOL = 1.2e-2
# A fault in one sequence moves one question's (GQA) or one key's (VG)
# scores and hardly moves the mean over all of them, so the largest |Δ| is
# held too: 1.36x (GQA) and 1.29x (VG) above the largest bf16 gap of that
# run (2.2e-2, 5.0e-2), and below the largest gap of the subtlest
# whole-batch fault (cls_segment_0's 4.3e-2, directions_swapped's 7.6e-2).
# The named faults of one sequence: the first question's [MASK] read one
# position late (GQA), the first sequence's first mask read one position
# late (VG; one direction of one pair, its width-1 predicates).
GQA_SCORE_MAX_TOL = 3.0e-2
VG_LOGPROB_MAX_TOL = 6.5e-2
GQA_ROW_FAULTS = ("one_mask_pos_shifted",)
VG_ROW_FAULTS = ("one_mask_pos_shifted",)


def task_labelmap(path: str) -> dict:
    """Write the phase's labelmap (``{"idx_to_label": ...}`` over the
    detector's classes) to ``path`` and load it as ``extract_features
    --labelmap`` does."""
    from cpt_tpu_torch.tools.extract_features import load_labelmap

    names = {str(i): (TASK_WORDS[i // 6 % len(TASK_WORDS)] if i % 6 == 0
                      else f"thing{i}") for i in range(1, 1595)}
    with open(path, "w") as f:
        json.dump({"idx_to_label": names}, f)
    return load_labelmap(path)


def task_image(rng, n: int = 10, h: int = 600, w: int = 800) -> tuple:
    """An h×w image and ``n`` boxes with class names from TASK_WORDS."""
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, [w - 120, h - 120], (n, 2))
    wh = rng.uniform(60, 260, (n, 2))
    boxes = np.round(np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1))
    names = [TASK_WORDS[i % len(TASK_WORDS)] for i in range(n)]
    return img, boxes.astype(np.float32), names


def vg_pairs(boxes: np.ndarray) -> list:
    """Every overlapping (subject < object) pair, as the reference's
    ``process_vg_data`` enumerates them (inclusive +1 IoU > 0)."""
    from cpt_tpu_torch.structures.boxes import box_iou_np

    iou = box_iou_np(boxes, boxes)
    np.fill_diagonal(iou, -1.0)
    return [(int(s), int(o)) for s, o in zip(*np.nonzero(iou > 0)) if s < o]


def ellipse_masks(boxes, hw) -> np.ndarray:
    """One filled ellipse inscribed in each box → [n, H, W] uint8."""
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    out = []
    for x1, y1, x2, y2 in boxes:
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        rx, ry = max((x2 - x1) / 2, 1), max((y2 - y1) / 2, 1)
        out.append(((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1)
    return np.asarray(out, np.uint8)


@contextlib.contextmanager
def gqa_fault(fault: str, data):
    """GQA scoring of ``data`` with one of GQA_FAULTS."""
    from cpt_tpu_torch.data import gqa

    real_rewrite, real_batch = gqa.gqa_rewrite_question, data.batch
    if fault == "rewrite_dropped":
        gqa.gqa_rewrite_question = lambda question, marks: question
    elif fault in ("mask_pos_shifted", "cls_segment_0", "one_mask_pos_shifted"):
        calls = []

        def batch(*a, **kw):
            b, tokens, answers = real_batch(*a, **kw)
            if fault == "mask_pos_shifted":
                b.mask_pos += 1
            elif fault == "cls_segment_0":
                b.segment_ids[:, 0] = 0
            elif not calls:
                b.mask_pos[0] += 1
            calls.append(1)
            return b, tokens, answers
        data.batch = batch
    else:
        raise ValueError(f"unknown GQA fault {fault!r}")
    try:
        yield
    finally:
        gqa.gqa_rewrite_question = real_rewrite
        data.batch = real_batch


@contextlib.contextmanager
def vg_one_mask_shifted(data):
    """VG scoring of ``data`` with the first mask of the run's first
    sequence read one position late."""
    real_batch, calls = data.batch, []

    def batch(*a, **kw):
        b, labels, mask_positions, meta = real_batch(*a, **kw)
        if not calls:
            mask_positions[0, 0] += 1
        calls.append(1)
        return b, labels, mask_positions, meta

    data.batch = batch
    try:
        yield
    finally:
        data.batch = real_batch


@contextlib.contextmanager
def vg_width_off_by_one():
    """``vg_cpt.evaluate`` reading a width-k predicate from the width k + 1
    sequence of its direction (the width-3 one from width 1)."""
    from cpt_tpu_torch.tools import vg_cpt

    real = vg_cpt.make_multi_mask_fn

    def make(model):
        fn = real(model)

        def rolled(*args):
            probs = fn(*args)
            n, w, v = probs.shape
            return np.roll(probs.reshape(n // 3, 3, w, v), -1, 1).reshape(n, w, v)
        return rolled

    vg_cpt.make_multi_mask_fn = make
    try:
        yield
    finally:
        vg_cpt.make_multi_mask_fn = real


def host_paint(image: np.ndarray, rects, colors, valid,
               inclusive: bool = False) -> np.ndarray:
    """``image`` with each valid rect painted ``[x1, x2)`` or, with
    ``inclusive``, ``[x1, x2]`` (at least one pixel, as ``ops/render``
    clamps it) in its RGBA color, one after another, by the PIL-exact
    integer blend on the host (numpy)."""
    out = image.astype(np.int32)
    for (x1, y1, x2, y2), c, v in zip(np.asarray(rects).astype(np.int32),
                                      colors, valid):
        if not v:
            continue
        if inclusive:
            x2, y2 = max(x2 + 1, x1 + 1), max(y2 + 1, y1 + 1)
        fg, a = np.asarray(c[:3], np.int32), int(c[3])
        region = out[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)]
        region[:] = (fg * a + region * (255 - a) + 127) // 255
    return out.astype(np.uint8)


def host_painted_features(extractor, tasks,
                          inclusive: bool | None = None) -> np.ndarray:
    """The region features of ``tasks``' copies (one copy each, all on one
    image and box set) painted on the host (:func:`host_paint`, by each
    task's ``inclusive_paint`` unless ``inclusive`` says otherwise) instead
    of on the device, through the extractor's chunk function as one chunk →
    [n, M, D]. Equal inputs give equal features: the device paint is
    exact integer math."""
    import torch

    from cpt_tpu_torch.structures.boxes import pad_boxes

    t0 = tasks[0]
    ih, iw = t0.image_rgb.shape[:2]
    h, w = extractor.pick_bucket(ih, iw)
    n = len(tasks)
    canvas = np.zeros((n, h, w, 3), np.uint8)
    for i, t in enumerate(tasks):
        canvas[i, :ih, :iw] = host_paint(
            t.image_rgb, t.copy_rects[0], t.copy_colors_rgba[0],
            t.copy_rect_valid[0],
            t.inclusive_paint if inclusive is None else inclusive)
    dets, det_valid = pad_boxes(t0.det_boxes,
                                extractor.det_bucket_for(len(t0.det_boxes)))
    dev = extractor._dev
    feats, _, _ = extractor.fn(
        dev(canvas), dev(np.zeros((n, 1, 4), np.float32)),
        dev(np.zeros((n, 1), bool)), dev(np.zeros((n, 1, 4), np.uint8)),
        dev(np.ones(n, bool)), dev(dets), dev(det_valid),
        tuple(int(v) for v in t0.image_hw))
    torch.cuda.synchronize()
    return feats.float().cpu().numpy()


def gqa_copy_features(path: str, n: int) -> np.ndarray:
    """The region features of the first ``n`` rows of a GQA extraction TSV
    (one copy a row, ``gqa_payload``'s layout) → [n, M, D]."""
    from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature

    tsv = TSVFile(path)
    rows = [[decode_feature(b["feature"])
             for b in json.loads(tsv.seek(i)[1])["objects"][0]]
            for i in range(n)]
    tsv.close()
    return np.asarray(rows)


def seg_request(res, extractor, img, dets, masks, wd: str) -> list:
    """One RefCOCO SEG request: ``cpt_predict.predict`` with each
    candidate's mask (RLE-encoded, then decoded as ``extract_features``
    reads ``"rle"`` dets) painted through ``extractor`` → the picked box."""
    from cpt_tpu_torch.data.refcoco import RefcocoCPTData, det_json_for_stage2
    from cpt_tpu_torch.engine.extract import refcoco_mask_task, refcoco_task
    from cpt_tpu_torch.engine.scoring import refcoco_evaluate
    from cpt_tpu_torch.tools import cpt_predict as cp
    from cpt_tpu_torch.utils import rle

    os.makedirs(wd, exist_ok=True)
    tsv = f"{wd}/predictions.tsv"
    if masks is None:        # the rect fault: each candidate's box painted
        task = refcoco_task("q0", img, img.shape[:2], dets, SERVE_CAPTION)
    else:
        decoded = np.stack([rle.decode(rle.encode(m)) for m in masks])
        task = refcoco_mask_task("q0", img, img.shape[:2], dets, decoded,
                                 SERVE_CAPTION)
    extractor.run([task], tsv)
    with open(f"{wd}/ann.json", "w") as f:
        json.dump([{"id": "q0", "caption": SERVE_CAPTION,
                    "height": int(img.shape[0])}], f)
    det_json_for_stage2(tsv, f"{wd}/stage2_det.json")
    data = RefcocoCPTData(tsv, f"{wd}/ann.json", f"{wd}/stage2_det.json",
                          res.tokenizer, img_feat_dim=res.bert_cfg.img_feature_dim)
    _acc, preds = refcoco_evaluate(res.oscar, data, res.tokenizer,
                                   batch_size=cp.SCORE_BATCH)
    data.tsv.close()
    return preds["q0"]


def run_other_tasks(res, counters, smi: str, rows: list) -> dict:
    """Phase 10 (see the module docstring) on phase 4's detector and
    Oscar-base. Gathers every reading, prints it, then raises on the first
    check that failed."""
    import torch

    from cpt_tpu_torch.data.gqa import GQACPTData, load_gqa_examples
    from cpt_tpu_torch.data.prompts import VG_PAIR_COLORS
    from cpt_tpu_torch.data.refcoco import tsv_region_features
    from cpt_tpu_torch.data.stage1_tasks import (gqa_mark_task,
                                                 parse_gqa_marks, plain_task,
                                                 vg_pair_task)
    from cpt_tpu_torch.data.vg import VGCPTData, reverse_imkey
    from cpt_tpu_torch.engine.evaluate import vg_recall_eval
    from cpt_tpu_torch.engine.extract import (Extractor, gqa_payload,
                                              plain_payload, vg_payload)
    from cpt_tpu_torch.tools import gqa_cpt, grad_gap, vg_cpt

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    # the kernels at the new launch shapes: GQA's eval batch (128 × (45 +
    # 45)) and VG's (48 × (70 + 50)); the training batches under "flash"
    check_k3(rows, 128, 90)
    check_k4(rows, 128 * 90)
    check_k3(rows, 48, 120)
    check_k4(rows, 48 * 120)
    check_flash(rows, [(16, 12, 90, "key"), (24, 12, 120, "key")])
    check_flash_bwd(rows, [(16, 12, 90, "key"), (24, 12, 120, "key")])

    dev, bf = res.device, torch.bfloat16
    det, det_cfg = res.detector, res.det_cfg
    oracle = rebuilt_scorer(res, torch.float32, attention_impl="einsum",
                            ffn_impl="dense").oscar
    state = {k: v.clone() for k, v in res.oscar.state_dict().items()}
    rng = np.random.RandomState(2030)
    out = {}

    def launches():
        return {k: fn.launches for k, fn in counters.items()}

    def idle(ran, busy):
        return all(n == 0 for k, n in ran.items() if k not in busy)

    def steps_of(train_fn, model, data, args, want_step):
        """Train through ``train_fn``; → (losses, per-call records, the
        calls whose launches are not ``want_step``'s)."""
        steps = []
        mark = [time.perf_counter(), {k: 0 for k in counters}]

        def on_step(step, loss):
            now = time.perf_counter()
            seen = launches()
            steps.append({"step": step, "loss": loss,
                          "ms": (now - mark[0]) * 1e3,
                          "launches": {k: seen[k] - mark[1][k] for k in seen}})
            mark[:] = [now, seen]

        zero_counts(counters)
        mark[0] = time.perf_counter()
        losses = train_fn(model, data, args, dev, on_step)
        bad = [st for st in steps
               if any(st["launches"][k] != n for k, n in want_step.items())]
        return losses, steps, bad

    want_step = {"K6": 12, "K6b": 12, "K6c": 12, "K3": 0, "K4": 0}
    with tempfile.TemporaryDirectory() as root:
        labelmap = task_labelmap(f"{root}/labelmap.json")

        # --- GQA: stage 1, parse → mark → inclusive paint, 8 questions on
        # one 600×800 image, and its plain (unpainted) features
        img, boxes, names = task_image(rng)
        ex = Extractor(det, det_cfg, copies_per_chunk=None, labelmap=labelmap)
        questions, tasks = [], []
        for q in range(8):
            name = names[q % len(names)]
            text = f"what color is the {name} on the left ?"
            marks = parse_gqa_marks(text, boxes.tolist(), names)
            tasks.append(gqa_mark_task(f"q{q}", img, img.shape[:2], boxes, marks))
            questions.append({"q_id": f"q{q}", "img_id": "im0",
                              "question": text, "label": q % len(GQA_ANSWERS)})
        zero_counts(counters)
        t0 = time.perf_counter()
        ex.run(tasks, f"{root}/gqa.tsv", payload_fn=gqa_payload)
        ex.run([plain_task("im0", img, img.shape[:2], boxes)],
               f"{root}/plain.tsv", payload_fn=plain_payload)
        torch.cuda.synchronize()
        gqa_stage1_ms = (time.perf_counter() - t0) * 1e3
        gqa_stage1 = launches()
        k1_paths(counters, gqa_stage1, "GQA stage 1")
        marks = [t.meta["positions_and_colors"] for t in tasks]
        check(gqa_stage1["K1"] == 100 and gqa_stage1["K2"] == 2
              and idle(gqa_stage1, ("K1", "K2")) and all(marks),
              f"GQA stage 1: launches {gqa_stage1}, marks {marks}")
        # stage 1's inclusive paint, bit for bit: the TSV's features against
        # the same copies painted [x1, x2] on the host; [x1, x2) must miss
        # (the TSV keeps the 10 boxes of the chunk's 16 det slots)
        gqa_feats = gqa_copy_features(f"{root}/gqa.tsv", len(tasks))
        gqa_paint_gap, gqa_exclusive_gap = (feature_gap(
            gqa_feats, host_painted_features(ex, tasks, inclusive=inc)[
                :, :len(boxes)]) for inc in (None, False))
        check(gqa_paint_gap == 0.0 < gqa_exclusive_gap,
              f"GQA stage-1 paint: gap {gqa_paint_gap}, painted [x1, x2) "
              f"{gqa_exclusive_gap}")
        with open(f"{root}/questions.json", "w") as f:
            json.dump(questions, f)
        ans2label = {a: i for i, a in enumerate(GQA_ANSWERS)}
        with open(f"{root}/ans2label.json", "w") as f:
            json.dump(ans2label, f)
        data = GQACPTData(f"{root}/plain.tsv", f"{root}/gqa.tsv",
                          load_gqa_examples(f"{root}/questions.json"),
                          ans2label, res.tokenizer, 45, 45,
                          res.bert_cfg.img_feature_dim)

        def flat(results):
            return np.stack([results[k]["scores"] for k in sorted(results)])

        zero_counts(counters)
        t0 = time.perf_counter()
        acc, got = gqa_cpt.evaluate(res.oscar, data, 128)
        torch.cuda.synchronize()
        gqa_eval_ms = (time.perf_counter() - t0) * 1e3
        gqa_eval = launches()
        want = flat(gqa_cpt.evaluate(oracle, data, 128)[1])
        gap, gap_max = (float(f(np.abs(flat(got) - want)))
                        for f in (np.mean, np.max))
        fault_gaps, fault_max = {}, {}
        for fault in GQA_FAULTS + GQA_ROW_FAULTS:
            with gqa_fault(fault, data):
                d = np.abs(flat(gqa_cpt.evaluate(res.oscar, data, 128)[1]) - want)
            fault_gaps[fault], fault_max[fault] = float(d.mean()), float(d.max())
        check(gqa_eval["K3"] == 12 and gqa_eval["K4"] == 12
              and idle(gqa_eval, ("K3", "K4")) and gap <= GQA_SCORE_TOL
              and gap_max <= GQA_SCORE_MAX_TOL
              and flat(got).shape == (8, len(GQA_ANSWERS)),
              f"GQA zero-shot: launches {gqa_eval}, gap {gap}, largest {gap_max}")
        check(all(fault_gaps[f] > GQA_SCORE_TOL for f in GQA_FAULTS)
              and all(fault_max[f] > GQA_SCORE_MAX_TOL for f in GQA_ROW_FAULTS),
              f"GQA zero-shot: a fault passes {fault_gaps}, largest {fault_max}")
        out["gqa"] = {"paint_gap": gqa_paint_gap,
                      "exclusive_paint_gap": gqa_exclusive_gap,
                      "stage1_ms": gqa_stage1_ms, "stage1_launches": gqa_stage1,
                      "eval_ms": gqa_eval_ms, "accuracy": acc, "gap": gap,
                      "gap_max": gap_max, "fault_gaps": fault_gaps,
                      "fault_gaps_max": fault_max,
                      "score_range": [float(want.min()), float(want.max())],
                      "launches": {k: gqa_stage1[k] + gqa_eval[k]
                                   for k in gqa_stage1}}

        # GQA prompt tuning under "flash": 32 questions drawn with
        # replacement, batch 16, so grad_accum_steps 2; TUNING_STEPS
        # optimizer steps
        args = gqa_cpt.build_args().parse_args(
            ["--img_feat_file", f"{root}/plain.tsv", "--questions",
             f"{root}/questions.json", "--ans2label", f"{root}/ans2label.json",
             "--n_sample", "32", "--per_gpu_train_batch_size", "16",
             "--num_train_epochs", str(TUNING_STEPS), "--random_seed", "0"])
        model = grad_gap.build(state, res.bert_cfg, bf, dev, **grad_gap.FLASH)
        losses, steps, bad = steps_of(gqa_cpt.train, model, data, args,
                                      want_step)
        gqa_train = launches()
        check(len(losses) == 2 * TUNING_STEPS and np.isfinite(losses).all()
              and not bad and idle(gqa_train, ("K6", "K6b", "K6c")),
              f"GQA training: losses {losses}, launches {gqa_train}, calls off "
              f"their counts {bad[:2]}")
        out["gqa_train"] = {"losses": losses, "steps": steps,
                            "ms_per_call": float(np.mean([s["ms"] for s in steps[1:]])),
                            "launches": gqa_train}
        data.img_feat_tsv.close()
        del model

        # --- VG: stage 1, every overlapping pair of one image (the boxes
        # redrawn until 16 pairs overlap), subject red, object blue
        for _ in range(1000):
            img, boxes, names = task_image(rng, n=8)
            pairs = vg_pairs(boxes)
            if len(pairs) == 16:
                break
        else:
            raise AssertionError("phase 10: no draw of 8 boxes with 16 pairs")
        ex_vg = Extractor(det, det_cfg, copies_per_chunk=None,
                          labelmap=labelmap)
        rel_of = {p: VG_PREDICATES[i * 7 % len(VG_PREDICATES)]
                  for i, p in enumerate(pairs)}

        def vg_tasks(colors=VG_PAIR_COLORS):
            return [vg_pair_task("vg0.jpg", img, img.shape[:2], boxes, s, o,
                                 names[s], names[o], rel_of[(s, o)],
                                 pair_colors=colors) for s, o in pairs]

        zero_counts(counters)
        t0 = time.perf_counter()
        ex_vg.run(vg_tasks(), f"{root}/vg.tsv", payload_fn=vg_payload)
        torch.cuda.synchronize()
        vg_stage1_ms = (time.perf_counter() - t0) * 1e3
        vg_stage1 = launches()
        k1_paths(counters, vg_stage1, "VG stage 1")
        check(vg_stage1["K1"] == 50 and vg_stage1["K2"] == 1
              and idle(vg_stage1, ("K1", "K2")),
              f"VG stage 1: launches {vg_stage1}")
        # stage 1's paint, bit for bit: the TSV's features against the same
        # copies painted on the host; the colors swapped must miss
        host = host_painted_features(ex_vg, vg_tasks())
        ex_vg.run(vg_tasks(VG_PAIR_COLORS[::-1]), f"{root}/vg_swapped.tsv",
                  payload_fn=vg_payload)
        def copy_features(path):
            return np.concatenate([tsv_region_features(path, i)
                                   for i in range(len(pairs))])

        paint_gap = feature_gap(copy_features(f"{root}/vg.tsv"), host)
        colors_gap = feature_gap(copy_features(f"{root}/vg_swapped.tsv"), host)
        check(paint_gap == 0.0 < colors_gap,
              f"VG stage-1 paint: gap {paint_gap}, colors swapped {colors_gap}")
        with open(f"{root}/predicates.json", "w") as f:
            json.dump({"idx_to_predicate": {str(i + 1): p for i, p in
                                            enumerate(VG_PREDICATES)}}, f)
        idx2tok = vg_cpt.predicate_tokens(res.tokenizer,
                                          f"{root}/predicates.json")
        data = VGCPTData(f"{root}/vg.tsv", res.tokenizer, 70, 50,
                         res.bert_cfg.img_feature_dim)

        def vg_flat(preds, keys):
            return np.stack([preds[k][1:] for k in keys])

        zero_counts(counters)
        t0 = time.perf_counter()
        preds = vg_cpt.evaluate(res.oscar, data, idx2tok, 48)
        torch.cuda.synchronize()
        vg_eval_ms = (time.perf_counter() - t0) * 1e3
        vg_eval = launches()
        want_preds = vg_cpt.evaluate(oracle, data, idx2tok, 48)
        keys = sorted(want_preds)
        want = vg_flat(want_preds, keys)
        gap, gap_max = (float(f(np.abs(vg_flat(preds, keys) - want)))
                        for f in (np.mean, np.max))
        with vg_width_off_by_one():
            width = vg_flat(vg_cpt.evaluate(res.oscar, data, idx2tok, 48), keys)
        swapped = VGCPTData(f"{root}/vg_swapped.tsv", res.tokenizer, 70, 50,
                            res.bert_cfg.img_feature_dim)
        colors = vg_flat(vg_cpt.evaluate(res.oscar, swapped, idx2tok, 48), keys)
        swapped.tsv.close()
        with vg_one_mask_shifted(data):
            one = vg_flat(vg_cpt.evaluate(res.oscar, data, idx2tok, 48), keys)
        diffs = {"directions_swapped": vg_flat(
                     preds, [reverse_imkey(k) for k in keys]) - want,
                 "width_off_by_one": width - want,
                 "one_mask_pos_shifted": one - want,
                 "colors_swapped": colors - want}
        fault_gaps = {f: float(np.abs(d).mean()) for f, d in diffs.items()
                      if f in VG_FAULTS + VG_ROW_FAULTS}
        fault_max = {f: float(np.abs(d).max()) for f, d in diffs.items()}
        colors_score_gap = float(np.abs(diffs["colors_swapped"]).mean())
        check(vg_eval["K3"] == 24 and vg_eval["K4"] == 24
              and idle(vg_eval, ("K3", "K4")) and gap <= VG_LOGPROB_TOL
              and gap_max <= VG_LOGPROB_MAX_TOL
              and len(preds) == 2 * len(pairs),
              f"VG zero-shot: launches {vg_eval}, gap {gap}, largest "
              f"{gap_max}, {len(preds)} keys")
        check(all(fault_gaps[f] > VG_LOGPROB_TOL for f in VG_FAULTS)
              and all(fault_max[f] > VG_LOGPROB_MAX_TOL for f in VG_ROW_FAULTS),
              f"VG zero-shot: a fault passes {fault_gaps}, largest {fault_max}")
        # recall on a synthetic ground truth: each pair's relation, and one
        # relation of a pair the image does not have
        gts = [{"img_path": "vg0.jpg", "relations": np.asarray(
            [[s, o, 1 + VG_PREDICATES.index(rel_of[(s, o)])] for s, o in pairs]
            + [[0, 0, 1]])}]
        recall = vg_recall_eval(preds, gts, num_classes=len(VG_PREDICATES) + 1)
        check(all(0.0 <= v <= 100.0 for v in recall.values())
              and recall["R@100"] <= 100.0 * len(pairs) / (len(pairs) + 1),
              f"VG recall {recall}")
        out["vg"] = {"pairs": len(pairs), "stage1_ms": vg_stage1_ms,
                     "stage1_launches": vg_stage1, "eval_ms": vg_eval_ms,
                     "gap": gap, "gap_max": gap_max, "fault_gaps": fault_gaps,
                     "fault_gaps_max": fault_max,
                     "colors_swapped_score_gap": colors_score_gap,
                     "paint_gap": paint_gap, "colors_swapped_paint_gap": colors_gap,
                     "recall": recall,
                     "logprob_range": [float(want.min()), float(want.max())],
                     "launches": {k: vg_stage1[k] + vg_eval[k] for k in vg_stage1}}

        # VG prompt tuning under "flash": 8 pairs (24 sequences) a step,
        # 16 pairs, 5 epochs
        args = vg_cpt.build_args().parse_args(
            ["--feat_file", f"{root}/vg.tsv", "--predicate_vocab",
             f"{root}/predicates.json", "--num_train_epochs", "5",
             "--per_gpu_train_batch_size", "8", "--seed", "0"])
        model = grad_gap.build(state, res.bert_cfg, bf, dev, **grad_gap.FLASH)
        losses, steps, bad = steps_of(vg_cpt.train, model, data, args, want_step)
        vg_train = launches()
        check(len(losses) == 10 and np.isfinite(losses).all() and not bad
              and idle(vg_train, ("K6", "K6b", "K6c")),
              f"VG training: losses {losses}, launches {vg_train}, steps off "
              f"their counts {bad[:2]}")
        out["vg_train"] = {"losses": losses, "steps": steps,
                           "ms_per_step": float(np.mean([s["ms"] for s in steps[1:]])),
                           "launches": vg_train}
        data.tsv.close()
        del model

        # --- SEG: one RefCOCO request whose 8 candidates carry elliptic
        # masks (RLE round trip), on the full path and windowed (two-level,
        # the window ladder); then its boxes painted instead (the fault)
        img, dets = windowed_request(np.random.RandomState(78))
        dets = np.asarray(dets[:8], np.float32)
        masks = ellipse_masks(dets, img.shape[:2])
        full_ex = Extractor(det, det_cfg, copies_per_chunk=None)
        win_ex = Extractor(det, det_cfg, copies_per_chunk=None, windowed=True,
                           window=WINDOW_LADDER, halo=160)
        check(win_ex.windowed_mode == "two_level",
              f"SEG windowed_mode {win_ex.windowed_mode}")
        log: list = []
        count_k1(win_ex, counters["K1"], log)
        zero_counts(counters)
        t0 = time.perf_counter()
        box_f = seg_request(res, full_ex, img, dets, masks, f"{root}/seg_full")
        torch.cuda.synchronize()
        seg_ms = (time.perf_counter() - t0) * 1e3
        seg_full = launches()
        k1_paths(counters, seg_full, "SEG full path")
        zero_counts(counters)
        t0 = time.perf_counter()
        box_w = seg_request(res, win_ex, img, dets, masks, f"{root}/seg_win")
        torch.cuda.synchronize()
        seg_win_ms = (time.perf_counter() - t0) * 1e3
        seg_win = launches()
        k1_paths(counters, seg_win, "SEG windowed")
        seg_routes = dict(win_ex.route_copies)
        seg_rect = seg_request(res, Extractor(det, det_cfg, copies_per_chunk=None),
                               img, dets, None, f"{root}/seg_rect")
        ff = tsv_region_features(f"{root}/seg_full/predictions.tsv")[..., :-6]
        fw = tsv_region_features(f"{root}/seg_win/predictions.tsv")[..., :-6]
        fr = tsv_region_features(f"{root}/seg_rect/predictions.tsv")[..., :-6]
        seg_gap, rect_gap = feature_gap(fw, ff), feature_gap(fr, ff)
        want_k1 = 11 + 50 * (len(log) - 1)
        check(seg_full["K1"] == 50 and seg_full["K2"] == 1
              and seg_full["K3"] == 12 and seg_full["K4"] == 12
              and idle(seg_full, ("K1", "K2", "K3", "K4")),
              f"SEG full path: launches {seg_full}")
        check(seg_win["K1"] == want_k1 and seg_routes["full"] >= 1
              and sum(seg_routes.values()) == 8
              and idle(seg_win, ("K1", "K2", "K3", "K4")),
              f"SEG windowed: launches {seg_win}, routes {seg_routes}, calls {log}")
        check(np.isfinite(ff).all() and ff.shape[:2] == (8, 8) and seg_gap == 0.0
              and box_w == box_f, f"SEG windowed against full: gap {seg_gap}, "
              f"boxes {box_w} {box_f}")
        check(rect_gap > WINDOW_TOL, f"SEG rect fault: gap {rect_gap}")
        out["seg"] = {"ms": seg_ms, "windowed_ms": seg_win_ms, "box": box_f,
                      "windowed_gap": seg_gap, "rect_fault_gap": rect_gap,
                      "routes": seg_routes, "k1_calls": log,
                      "windowed_launches": seg_win,
                      "launches": {k: seg_full[k] + seg_win[k] for k in seg_full}}
    del oracle
    phase_s = time.perf_counter() - t_phase
    g, v, s = out["gqa"], out["vg"], out["seg"]
    print(f"phase 10 other CPT tasks ({smi}) in {phase_s:.1f} s: GQA stage 1 "
          f"(8 questions + plain, 600x800) {g['stage1_ms']:.1f} ms, launches "
          f"{g['stage1_launches']}, features against the host's [x1, x2] "
          f"paint {g['paint_gap']:.1e} ([x1, x2) {g['exclusive_paint_gap']:.3e}"
          f"); zero-shot [128,90] {g['eval_ms']:.1f} ms, "
          f"mean gap to f32 {g['gap']:.3e} (GQA_SCORE_TOL {GQA_SCORE_TOL}; "
          f"largest {g['gap_max']:.3e}, GQA_SCORE_MAX_TOL {GQA_SCORE_MAX_TOL}"
          f"), scores "
          f"{g['score_range'][0]:.4f}..{g['score_range'][1]:.4f}, faults "
          + ", ".join(f"{f} {e:.3e} ({e / GQA_SCORE_TOL:.1f}x tol; largest "
                      f"{g['fault_gaps_max'][f]:.3e}, "
                      f"{g['fault_gaps_max'][f] / GQA_SCORE_MAX_TOL:.1f}x max tol)"
                      for f, e in g["fault_gaps"].items())
          + f"; training {len(out['gqa_train']['losses'])} calls (accumulation "
          f"2), ms/call {out['gqa_train']['ms_per_call']:.2f}, losses "
          f"{out['gqa_train']['losses'][0]:.4f} -> "
          f"{out['gqa_train']['losses'][-1]:.4f}; VG stage 1 ({v['pairs']} "
          f"pairs) {v['stage1_ms']:.1f} ms, launches {v['stage1_launches']}; "
          f"zero-shot [48,120] {v['eval_ms']:.1f} ms, mean gap to f32 "
          f"{v['gap']:.3e} (VG_LOGPROB_TOL {VG_LOGPROB_TOL}; largest "
          f"{v['gap_max']:.3e}, VG_LOGPROB_MAX_TOL {VG_LOGPROB_MAX_TOL}), "
          f"log-probs "
          f"{v['logprob_range'][0]:.3f}..{v['logprob_range'][1]:.3f}, faults "
          + ", ".join(f"{f} {e:.3e} ({e / VG_LOGPROB_TOL:.1f}x tol; largest "
                      f"{v['fault_gaps_max'][f]:.3e}, "
                      f"{v['fault_gaps_max'][f] / VG_LOGPROB_MAX_TOL:.1f}x max tol)"
                      for f, e in v["fault_gaps"].items())
          + f"; colors swapped: scores {v['colors_swapped_score_gap']:.3e} "
          f"(largest {v['fault_gaps_max']['colors_swapped']:.3e}), stage-1 "
          f"features {v['colors_swapped_paint_gap']:.3e} of scale against the "
          f"host paint (the sound paint {v['paint_gap']:.1e})"
          + f", recall {v['recall']}; training {len(out['vg_train']['losses'])} "
          f"steps, ms/step {out['vg_train']['ms_per_step']:.2f}; SEG request "
          f"full {s['ms']:.1f} ms, windowed {s['windowed_ms']:.1f} ms (routes "
          f"{s['routes']}, K1 calls {s['k1_calls']}), windowed gap "
          f"{s['windowed_gap']:.4e}, rect fault {s['rect_fault_gap']:.4e} "
          f"({s['rect_fault_gap'] / WINDOW_TOL:.1f}x WINDOW_TOL)", flush=True)
    if failed:
        raise AssertionError(f"phase 10: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 11: the full-finetune baselines (REC_FT, GQA's and VCR's FT
# variants, the other FT heads, the few-shot sweep) at full width. Named
# faults each tolerance must see: REC_FT reading the image hiddens one
# position early, scoring without its box mask (empty slots get real
# scores) and skipping its cls_LayerNorm; the GQA classifier reading the
# raw [CLS] hidden instead of the pooled output; VCR's FT runs with the
# pooler on the last position, the twin run scored with its other
# classifier; VGFT with subject and object swapped, the sequence
# classifier on the [CLS] hidden, the multiple-choice model without its
# cls_LayerNorm.
REC_FT_FAULTS = ("image_hiddens_early", "box_mask_dropped",
                 "cls_layernorm_skipped")
GQA_FT_FAULTS = ("classifier_on_cls_hidden",)
VCR_FT_FAULTS = ("pooler_last_token",)
FT_HEAD_FAULTS = {"vg_ft": "pairs_swapped",
                  "seq_classification": "classifier_on_cls_hidden",
                  "multiple_choice": "cls_layernorm_skipped"}
# Phase 11's tolerances, bf16 on the card against the f32 einsum path on
# the same weights rounded to bf16: REC_FT's scores and VCR's NSP scores as
# the largest |Δ| (REC_FT's empty slots compared in bf16, where ATTN_FILL
# rounds to −9984), the other heads' logits as the largest |Δ| over the
# largest |logit|. Each is set from the calibration run (H100 80GB HBM3,
# 700 W; phase 11 alone, twice, the same readings both times): at most 3×
# the sound gap, and the geometric mean of the sound gap and the smallest
# fault's where that is lower. REC_FT: bf16 4.393e-2 (scores −2.20 to
# −2.02), faults 0.4453 (cls_LayerNorm skipped) to 9983 (box mask dropped),
# 1.3e-1 is 2.96× and 3.4× from them. GQA FT: 2.104e-2 of 0.741, the
# [CLS]-hidden fault 3.321; 6e-2 (2.85×). VCR FT: 3.868e-3 to 4.057e-3
# (scores 0.26-0.55), the faults 8.698e-3 (the pooler on the last position
# for the twin's rationale classifier) to 0.2784; 6e-3, the geometric mean
# (1.48× and 1.45×). The other heads: 9.860e-3 to 1.368e-2, the faults
# 0.6573 to 2.259; 4e-2 (2.92×).
REC_FT_SCORE_TOL = 1.3e-1
GQA_FT_LOGIT_TOL = 6e-2
VCR_FT_SCORE_TOL = 6e-3
FT_LOGIT_TOL = 4e-2
# One REC_FT step's gradients (the trained weights, a synthetic batch of 16,
# dropout off) as phase 5 measures them (largest per-tensor relative L2,
# each wqkv by q / k / v). GRAD_TOL cannot hold them: in the calibration run
# the plain path in bf16, which runs no kernel, sat at 6.022e-2 (layer 7's
# qkv bias) and the flash path at 5.529e-2. By GRAD_TOL's own rule (from
# the plain path's bf16 gap) the limit is 2× the plain gap, 8.3× below K6b's
# dK zeroed (1.0).
REC_FT_GRAD_TOL = 1.2e-1
# the sweep's stage-2 depth: it drives the sweep through the tool and
# times nothing
SWEEP_LAYERS = 2


@contextlib.contextmanager
def config_changed(model, **changes):
    """Every module of ``model`` that carries the BERT config sees it with
    ``changes`` (the attention backend, the loss type) meanwhile."""
    mods = [m for m in model.modules() if hasattr(m, "config")]
    old = [m.config for m in mods]
    set_config(model, **changes)
    try:
        yield
    finally:
        for m, c in zip(mods, old):
            m.config = c


@contextlib.contextmanager
def ft_fault(model, fault: str):
    """``model`` (a finetune baseline) with one named fault, by a forward
    hook: ``image_hiddens_early`` (each position reads the hidden state
    before it), ``classifier_on_cls_hidden`` (the raw [CLS] hidden in place
    of the pooled output), ``cls_layernorm_skipped``."""
    import torch

    if fault == "image_hiddens_early":
        hook = model.bert.register_forward_hook(lambda m, i, out: (
            torch.cat([out[0][:, :1], out[0][:, :-1]], 1), out[1]))
    elif fault == "classifier_on_cls_hidden":
        hook = model.bert.register_forward_hook(
            lambda m, i, out: (out[0], out[0][:, 0]))
    elif fault == "cls_layernorm_skipped":
        hook = model.cls_LayerNorm.register_forward_hook(lambda m, i, out: i[0])
    else:
        raise ValueError(f"unknown FT fault {fault!r}")
    try:
        yield
    finally:
        hook.remove()


def ft_oracle(model, **kw):
    """``model``'s class on the f32 einsum path, loaded with ``model``'s
    weights as it computes with them: the matrices and tables rounded to
    bf16, the vectors f32 (as the kernels and every LayerNorm read them)."""
    import torch

    with torch.device(next(model.parameters()).device):
        oracle = type(model)(dataclasses.replace(
            model.config, attention_impl="einsum", ffn_impl="dense"),
            dtype=torch.float32, **kw).eval()
    oracle.load_state_dict({k: v.to(torch.bfloat16).float() if v.dim() > 1
                            else v for k, v in model.state_dict().items()})
    return oracle


def rec_ft_rows(model, data, box_mask: bool = True,
                batch_size: int = 64) -> tuple:
    """REC_FT's f32 score rows [n, R] (every slot) of all ``n`` queries of
    ``data`` as one padded batch of ``batch_size`` → (rows, box masks,
    keys); without ``box_mask`` the model scores every slot (a fault)."""
    import torch

    dev = next(model.parameters()).device
    b = data.batch(list(range(len(data))), pad_to=batch_size)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in b[:5]]
    with torch.inference_mode():
        _, scores, _ = model.eval()(t[0], t[1], t[2], img_feats=t[3],
                                    box_mask=t[4] if box_mask else None)
    n = len(data)
    return scores.float().cpu().numpy()[:n], b[4][:n], b[6]


def rec_ft_gap(got, want, box_mask, dtype) -> float:
    """The largest |Δ| of REC_FT scores: at the candidates' slots against
    the f32 scores, at the empty ones against them rounded to the model's
    ``dtype`` (where ATTN_FILL is −9984 in bf16)."""
    import torch

    want_dt = torch.from_numpy(want).to(dtype).float().numpy()
    return float(np.abs(got - np.where(box_mask, want, want_dt)).max())


def rec_ft_batch(cfg, n: int, seed: int, dev) -> tuple:
    """A REC_FT training batch on ``grad_gap``'s synthetic sequences (70
    text + 50 region slots, padding drawn from ``seed``): the box mask is
    the regions' attention mask, the target one candidate a sequence."""
    import torch

    from cpt_tpu_torch.tools import grad_gap

    ids, seg, mask, feats, _, _ = grad_gap.synthetic_batch(cfg, n, seed, dev)
    box_mask = mask[:, 70:] > 0
    rng = np.random.RandomState(seed)
    target = [rng.randint(0, k) for k in box_mask.sum(1).cpu().numpy()]
    return ids, seg, mask, feats, box_mask, torch.tensor(target, device=dev)


# REC_FT's parameters whose gradient is zero in exact arithmetic: each adds
# the same amount to every candidate's score, and the cross entropy over
# candidates does not see a shift (the f32 reference holds only rounding
# noise there, so a relative gap to it measures nothing)
REC_FT_SHIFT_PARAMS = ("cls_out.bias", "cls_LayerNorm.bias")


def rec_ft_grads(model, batch) -> dict:
    """REC_FT's f32 gradient of every parameter but REC_FT_SHIFT_PARAMS,
    dropout off, each wqkv gradient split by q / k / v (``split_qkv``)."""
    import torch

    ids, seg, mask, feats, box_mask, target = batch
    loss, _, _ = model.eval()(ids, seg, mask, img_feats=feats,
                              box_mask=box_mask, target_idx=target)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return split_qkv({n: (torch.zeros_like(p) if g is None else g.float())
                      for (n, p), g in zip(params.items(), grads)
                      if n not in REC_FT_SHIFT_PARAMS})


def ft_head_batch(name: str, cfg, dev, seed: int = 5) -> dict:
    """One full-width batch of 16 sequences (70 text + 50 region slots,
    ``grad_gap``'s synthetic draw) for a finetune head's forward → its
    keyword inputs (``args`` the positional ones): VGFT's 8 subject/object
    pairs a sequence with relation labels, the sequence classifier's soft
    labels (kl) over ``cfg.num_labels`` answers, the multiple-choice
    model's 8 examples of 2 choices."""
    import torch

    from cpt_tpu_torch.tools import grad_gap

    ids, seg, mask, feats, _, _ = grad_gap.synthetic_batch(cfg, 16, seed, dev)
    rng = np.random.RandomState(seed)
    if name == "vg_ft":
        n_box = (mask[:, 70:] > 0).sum(1).cpu().numpy()
        pairs = np.stack([rng.randint(0, k, (8, 2)) for k in n_box])
        kw = {"pairs": torch.from_numpy(pairs).to(dev),
              "rel_labels": torch.from_numpy(rng.randint(0, 51, (16, 8))).to(dev)}
    elif name == "seq_classification":
        soft = rng.rand(16, cfg.num_labels) * (rng.rand(16, cfg.num_labels) > 0.99)
        soft[:, 0] += 0.1
        kw = {"labels": torch.from_numpy(
            (soft / soft.sum(1, keepdims=True)).astype(np.float32)).to(dev)}
    else:
        ids, seg, mask, feats = (t.reshape((8, 2) + t.shape[1:])
                                 for t in (ids, seg, mask, feats))
        kw = {"labels": torch.from_numpy(rng.randint(0, 2, 8)).to(dev)}
    return {"args": (ids, seg, mask), "img_feats": feats, **kw}


class Driven:
    """Drives a tool's ``main``: each step of its ``train`` (run with the
    model's config changed by ``train_changes``, if any) records its loss,
    host ms and launches; each call of the functions named in ``evals``
    records (model, args, result, host ms, launches); ``build(model)``, if
    given, runs on each model the tool's ``build_model`` returns. The
    counts are zeroed just before each step and call and read just after
    it; a step's host ms run from the end of the step or call before it."""

    def __init__(self, module, evals, counters, train_changes=None, build=None):
        self.module, self.evals, self.counters = module, evals, counters
        self.train_changes, self.build = train_changes, build
        self.steps, self.calls, self.losses = [], [], []
        self.model, self.train_launches, self.mark = None, {}, 0.0

    def launches(self) -> dict:
        return {k: fn.launches for k, fn in self.counters.items()}

    def total(self) -> dict:
        """The launches of the whole run: training's and every call's."""
        return {k: self.train_launches.get(k, 0)
                + sum(c["launches"][k] for c in self.calls)
                for k in self.counters}

    def __enter__(self):
        mod = self.module
        names = ("train",) + self.evals + (("build_model",) if self.build
                                           else ())
        self.real = {n: getattr(mod, n) for n in names}
        mod.train = self._training(self.real["train"])
        for name in self.evals:
            setattr(mod, name, self._recording(self.real[name]))
        if self.build:
            mod.build_model = self._building(self.real["build_model"])
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.module, name, fn)
        return False

    def _building(self, real):
        def build_model(*a, **kw):
            model = real(*a, **kw)
            self.build(model)
            return model
        return build_model

    def _training(self, real):
        def train(model, *a, **kw):
            def on_step(step, loss):
                self.steps.append({"step": step, "loss": loss, "ms": (
                    time.perf_counter() - self.mark) * 1e3,
                                   "launches": self.launches()})
                zero_counts(self.counters)
                self.mark = time.perf_counter()

            self.model = model
            with (config_changed(model, **self.train_changes)
                  if self.train_changes else contextlib.nullcontext()):
                zero_counts(self.counters)
                self.mark = time.perf_counter()
                self.losses = real(model, *a, on_step=on_step, **kw)
            tail = self.launches()
            self.train_launches = {k: n + sum(st["launches"][k]
                                              for st in self.steps)
                                   for k, n in tail.items()}
            return self.losses
        return train

    def _recording(self, real):
        import torch

        def run(model, *a, **kw):
            zero_counts(self.counters)
            t0 = time.perf_counter()
            result = real(model, *a, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.calls.append({"name": real.__name__, "model": model,
                               "args": a, "kw": kw,
                               "result": result, "launches": self.launches(),
                               "ms": (time.perf_counter() - t0) * 1e3})
            zero_counts(self.counters)
            self.mark = time.perf_counter()
            return result
        return run

    def bad_steps(self, want: dict) -> list:
        return [st for st in self.steps
                if any(st["launches"][k] != n for k, n in want.items())]

    def ms_per_step(self) -> float:
        return float(np.mean([st["ms"] for st in self.steps[1:]]))


def run_ft_baselines(res, counters, smi: str, rows: list) -> dict:
    """Phase 11 (see the module docstring) on phase 4's detector, with the
    finetune tools' own models (random reference-layout encoders from their
    seeds, fresh heads). Gathers every reading, prints it, then raises on
    the first check that failed."""
    import torch

    from cpt_tpu_torch.data.stage1_tasks import plain_task
    from cpt_tpu_torch.engine.evaluate import seed_sweep_report
    from cpt_tpu_torch.engine.extract import plain_payload, vcr_payload
    from cpt_tpu_torch.models.bert import heads
    from cpt_tpu_torch.tools import (fewshot_eval, gqa_cpt, grad_gap,
                                     refcoco_ft, sweep, vcr_nsp_cpt)
    from cpt_tpu_torch.utils import checkpoint as ckpt_lib
    from cpt_tpu_torch.utils import convert as cv

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def launches():
        return {k: fn.launches for k, fn in counters.items()}

    def idle(ran, busy):
        return all(n == 0 for k, n in ran.items() if k not in busy)

    t_phase = time.perf_counter()
    # the kernels at REC_FT's launch shapes: its eval batch (64 × (70 +
    # 50)), K4 at its 7,680 rows, K6b / K6c at its training batch (K6 at
    # [16,12,120,64] is phase 3's serving row)
    if res.device.type == "cuda":
        check_k3(rows, 64, 120)
        check_k4(rows, 64 * 120)
        check_flash_bwd(rows, [(16, 12, 120, "key")])

    dev, dt, bcfg = res.device, res.oscar.dtype, res.bert_cfg

    def flags(layers: int = bcfg.num_hidden_layers) -> list:
        return ["--device", dev.type, "--dtype",
                "bfloat16" if dt == torch.bfloat16 else "float32",
                "--hidden_size", str(bcfg.hidden_size), "--num_hidden_layers",
                str(layers), "--img_feature_dim", str(bcfg.img_feature_dim)]

    flash = dict(attention_impl="flash", attention_probs_dropout_prob=0.0)
    want_step = {"K6": 12, "K6b": 12, "K6c": 12, "K3": 0, "K4": 0}
    want_eval = {"K3": 12, "K4": 12, "K6": 0, "K6b": 0, "K6c": 0}

    def eval_ok(ran) -> bool:
        return (all(ran[k] == n for k, n in want_eval.items())
                and idle(ran, ("K3", "K4")))

    def train_ok(drv, n_calls) -> bool:
        return (len(drv.losses) == n_calls and np.isfinite(drv.losses).all()
                and not drv.bad_steps(want_step)
                and idle(drv.train_launches, ("K6", "K6b", "K6c")))

    out = {}
    with tempfile.TemporaryDirectory() as root:
        # --- (b) REC_FT on phase 5's 16 stage-1 queries (4 candidates
        # each): TUNING_STEPS steps of batch 16 under "flash", then eval at 64
        data5, paths, _ = training_data(res, root)
        data5.tsv.close()
        with Driven(refcoco_ft, ("evaluate",), counters, flash) as rec:
            rec_acc = refcoco_ft.main(
                ["--data_file", paths["data_file"], "--ann_file",
                 paths["ann_file"], "--num_train_epochs", str(TUNING_STEPS),
                 "--per_gpu_train_batch_size", "16",
                 "--per_gpu_eval_batch_size", "64", "--seed", "0",
                 "--output", f"{root}/rec_ft.pk"] + flags())
        call = rec.calls[-1]
        model, data = call["model"], call["args"][0]
        _, preds, scores = call["result"]
        with open(f"{root}/rec_ft.pk", "rb") as f:
            saved = pickle.load(f)
        got, box_mask, keys = rec_ft_rows(model, data)
        oracle = ft_oracle(model, txt_seq_len=model.txt_seq_len)
        want = rec_ft_rows(oracle, data)[0]
        gap = rec_ft_gap(got, want, box_mask, dt)
        faults = {"box_mask_dropped": rec_ft_gap(
            rec_ft_rows(model, data, box_mask=False)[0], want, box_mask, dt)}
        for fault in REC_FT_FAULTS[::2]:
            with ft_fault(model, fault):
                faults[fault] = rec_ft_gap(rec_ft_rows(model, data)[0], want,
                                           box_mask, dt)
        same = all(np.array_equal(scores[k], got[i, :len(scores[k])])
                   for i, k in enumerate(keys))
        check(train_ok(rec, TUNING_STEPS),
              f"REC_FT training: losses {rec.losses}, launches "
              f"{rec.train_launches}, steps off their counts "
              f"{rec.bad_steps(want_step)[:2]}")
        check(eval_ok(call["launches"]) and gap <= REC_FT_SCORE_TOL and same
              and len(preds) == len(data) == 16 and saved["accuracy"] == rec_acc
              and saved["predictions"] == preds,
              f"REC_FT eval: launches {call['launches']}, gap {gap}, scores "
              f"from evaluate equal {same}, {len(preds)} predictions")
        check(all(e > REC_FT_SCORE_TOL for e in faults.values()),
              f"REC_FT eval: a fault passes {faults}")
        out["rec_ft_train"] = {"losses": rec.losses, "steps": rec.steps,
                               "ms_per_step": rec.ms_per_step(),
                               "launches": rec.train_launches}
        out["rec_ft"] = {"accuracy": rec_acc, "gap": gap, "fault_gaps": faults,
                         "eval_ms": call["ms"], "launches": call["launches"],
                         "score_range": [float(got[box_mask].min()),
                                         float(got[box_mask].max())]}
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        cfg = model.config
        del model, oracle

        # one step's gradients, dropout off, flash bf16 against einsum f32
        # on the trained weights, on a synthetic batch of 16
        batch = rec_ft_batch(cfg, 16, 0, dev)

        def build(dtype, **changes):
            with torch.device(dev):
                m = heads.REC_FT(dataclasses.replace(cfg, **changes),
                                 dtype=dtype).eval()
            m.load_state_dict(state)
            return m

        ref = rec_ft_grads(build(torch.float32, **grad_gap.PLAIN), batch)
        flash_m = build(dt, **grad_gap.FLASH)
        grads = {"flash": grad_gap.gap(rec_ft_grads(flash_m, batch), ref),
                 "plain_bf16": grad_gap.gap(rec_ft_grads(
                     build(dt, **grad_gap.PLAIN), batch), ref)}
        with grad_gap.zeroed_dk():
            grads["flash_dk_zeroed"] = grad_gap.gap(rec_ft_grads(flash_m, batch),
                                                    ref)
        check(grads["flash"][0] <= REC_FT_GRAD_TOL
              < grads["flash_dk_zeroed"][0], f"REC_FT gradient check {grads}")
        out["rec_ft"]["gradient_gaps"] = grads
        del ref, flash_m, state

        # --- (c) GQA FT: 8 questions on one image's plain features; 10
        # optimizer steps (32 samples, batch 16, 2 calls a step) under
        # "flash", eval at [128,90], --save_dir, a fresh model loaded
        img, boxes, names = task_image(np.random.RandomState(2031))
        res.extractor.run([plain_task("im0", img, img.shape[:2], boxes)],
                          f"{root}/plain.tsv", payload_fn=plain_payload)
        questions = [{"q_id": f"q{q}", "img_id": "im0",
                      "question": f"what color is the {names[q]} on the left ?",
                      "label": q % len(GQA_ANSWERS)} for q in range(8)]
        with open(f"{root}/questions.json", "w") as f:
            json.dump(questions, f)
        with open(f"{root}/ans2label.json", "w") as f:
            json.dump({a: i for i, a in enumerate(GQA_ANSWERS)}, f)
        gqa_data = ["--img_feat_file", f"{root}/plain.tsv", "--questions",
                    f"{root}/questions.json", "--ans2label",
                    f"{root}/ans2label.json", "--model_variant", "ft"]
        with Driven(gqa_cpt, ("evaluate",), counters, flash) as gq:
            gqa_acc = gqa_cpt.main(gqa_data + flags() + [
                "--n_sample", "32", "--per_gpu_train_batch_size", "16",
                "--num_train_epochs", str(TUNING_STEPS), "--random_seed", "0",
                "--save_dir", f"{root}/gqa_ft"])
        call = gq.calls[-1]
        model, data = call["model"], call["args"][0]

        def logits(results):
            return np.stack([results[k]["scores"] for k in sorted(results)])

        got = logits(call["result"][1])
        oracle = ft_oracle(model)
        want = logits(gqa_cpt.evaluate(oracle, data, 128, "ft")[1])
        scale = float(np.abs(want).max())
        gap = float(np.abs(got - want).max()) / scale
        faults = {}
        for fault in GQA_FT_FAULTS:
            with ft_fault(model, fault):
                d = logits(gqa_cpt.evaluate(model, data, 128, "ft")[1]) - want
            faults[fault] = float(np.abs(d).max()) / scale
        args = gqa_cpt.build_args().parse_args(gqa_data + flags()
                                               + ["--random_seed", "1"])
        fresh = gqa_cpt.load_ft_model(args, gqa_cpt.model_config(args), dev, dt,
                                      len(GQA_ANSWERS))
        differs = not torch.equal(fresh.cls_out.kernel, model.cls_out.kernel)
        fresh.load_state_dict(ckpt_lib.load_model(f"{root}/gqa_ft",
                                                  fresh.state_dict()))
        reloaded = logits(gqa_cpt.evaluate(fresh, data, 128, "ft")[1])
        bit_equal = bool(np.array_equal(reloaded, got))
        with open(f"{root}/gqa_ft/config.json") as f:
            saved_cfg = json.load(f)
        check(train_ok(gq, 2 * TUNING_STEPS),
              f"GQA FT training: losses {gq.losses}, launches "
              f"{gq.train_launches}, calls off their counts "
              f"{gq.bad_steps(want_step)[:2]}")
        check(eval_ok(call["launches"]) and gap <= GQA_FT_LOGIT_TOL
              and got.shape == (8, len(GQA_ANSWERS)),
              f"GQA FT eval: launches {call['launches']}, gap {gap}")
        check(all(e > GQA_FT_LOGIT_TOL for e in faults.values()),
              f"GQA FT eval: a fault passes {faults}")
        check(differs and bit_equal
              and saved_cfg["num_labels"] == len(GQA_ANSWERS),
              f"GQA FT --save_dir: reloaded logits equal {bit_equal} (largest "
              f"|Δ| {float(np.abs(reloaded - got).max())}), the fresh head "
              f"differed {differs}, config {saved_cfg.get('num_labels')}")
        out["gqa_ft_train"] = {"losses": gq.losses, "steps": gq.steps,
                               "ms_per_call": gq.ms_per_step(),
                               "launches": gq.train_launches}
        out["gqa_ft"] = {"accuracy": gqa_acc, "gap": gap, "fault_gaps": faults,
                         "eval_ms": call["ms"], "launches": call["launches"],
                         "logit_scale": scale, "save_dir_bit_equal": bit_equal}
        del model, oracle, fresh

        # --- (d) VCR FT: 4 questions painted and extracted as in phase 9;
        # q->a trains TUNING_STEPS steps under "flash", then q->a and q->ar (the twin
        # classifiers) score under "auto"
        tasks, examples = vcr_questions(np.random.RandomState(2032))
        res.extractor.run(tasks, f"{root}/vcr.tsv", payload_fn=vcr_payload)
        with open(f"{root}/vcr.json", "w") as f:
            json.dump(examples, f)

        def flat(results):
            return np.asarray([s for q in sorted(results)
                               for s in results[q]["scores"]])

        vcr = {}
        for task, epochs in (("qa", str(TUNING_STEPS)), ("qar", "0")):
            with Driven(vcr_nsp_cpt, ("run_eval",), counters, flash) as vc:
                vcr_acc = vcr_nsp_cpt.main(
                    ["--feat_file", f"{root}/vcr.tsv", "--examples",
                     f"{root}/vcr.json", "--model_variant", "ft", "--task", task,
                     "--num_train_epochs", epochs, "--per_gpu_train_batch_size",
                     "4", "--per_gpu_eval_batch_size", "8", "--seed", "0"]
                    + flags())
            if task == "qa":
                check(train_ok(vc, TUNING_STEPS),
                      f"VCR FT training: losses {vc.losses}, launches "
                      f"{vc.train_launches}, steps off their counts "
                      f"{vc.bad_steps(want_step)[:2]}")
                out["vcr_ft_train"] = {"losses": vc.losses, "steps": vc.steps,
                                       "ms_per_step": vc.ms_per_step(),
                                       "launches": vc.train_launches}
            model = vc.calls[0]["model"]
            oracle = ft_oracle(model)
            for call in vc.calls:
                head = call["kw"].get("head")
                rat = call["kw"].get("use_rationale", False)
                data = call["args"][0]
                want = flat(vcr_nsp_cpt.run_eval(oracle, data, 8, head=head,
                                                 use_rationale=rat)[1])
                gap = float(np.abs(flat(call["result"][1]) - want).max())

                def fault_gap(h):
                    return float(np.abs(flat(vcr_nsp_cpt.run_eval(
                        model, data, 8, head=h, use_rationale=rat)[1])
                        - want).max())

                faults = {}
                for fault in VCR_FT_FAULTS:
                    with vcr_fault(fault, data):
                        faults[fault] = fault_gap(head)
                if head is not None:
                    faults["head_swapped"] = fault_gap(
                        {"ans": "rat", "rat": "ans"}[head])
                name = task if head is None else f"{task} {head}"
                vcr[name] = {"accuracy": vcr_acc, "gap": gap,
                             "fault_gaps": faults, "ms": call["ms"],
                             "launches": call["launches"],
                             "score_range": [float(want.min()),
                                             float(want.max())]}
                check(eval_ok(call["launches"]) and gap <= VCR_FT_SCORE_TOL
                      and len(want) == 4 * len(tasks),
                      f"VCR FT {name}: launches {call['launches']}, gap {gap}")
                check(all(e > VCR_FT_SCORE_TOL for e in faults.values()),
                      f"VCR FT {name}: a fault passes {faults}")
            del model, oracle
        out["vcr_ft"] = {"runs": vcr, "launches": {
            k: sum(v["launches"][k] for v in vcr.values()) for k in counters}}

        # --- (e) one full-width forward of each other FT head, bf16 under
        # "auto" against the f32 einsum path, with a named fault each
        sd = cv.random_oscar_state_dict(cfg, seed=7)
        others = {}
        for name, cls, changes, kw in (
                ("vg_ft", heads.VGFT, {}, {}),
                ("seq_classification", heads.ImageBertForSequenceClassification,
                 dict(classifier="mlp", loss_type="kl", num_labels=3129), {}),
                ("multiple_choice", heads.ImageBertForMultipleChoice,
                 dict(classifier="mlp", use_img_layernorm=True),
                 {"num_choices": 2})):
            hcfg = dataclasses.replace(cfg, **changes)
            with torch.device(dev):
                model = cls(hcfg, dtype=dt, **kw).eval()
            model.init_heads(torch.Generator().manual_seed(7))
            cv.load_bert_only(model, sd)
            oracle = ft_oracle(model, **kw)
            b = ft_head_batch(name, hcfg, dev)

            def run(m, inputs):
                with torch.inference_mode():
                    loss, logit = m(*inputs["args"], **{
                        k: v for k, v in inputs.items() if k != "args"})[:2]
                return float(loss), logit.float().cpu().numpy()

            zero_counts(counters)
            loss, got = run(model, b)
            ran = launches()
            w_loss, want = run(oracle, b)
            scale = float(np.abs(want).max())
            entry = {"gap": float(np.abs(got - want).max()) / scale,
                     "loss": loss, "loss_f32": w_loss, "launches": ran}
            fault = FT_HEAD_FAULTS[name]
            if fault == "pairs_swapped":
                f_logits = run(model, dict(b, pairs=b["pairs"].flip(-1)))[1]
            else:
                with ft_fault(model, fault):
                    f_logits = run(model, b)[1]
            entry["fault_gaps"] = {
                fault: float(np.abs(f_logits - want).max()) / scale}
            if name == "seq_classification":    # the same logits under bce
                labels = np.random.RandomState(6).choice(
                    [0.0, 1.0], got.shape, p=[0.99, 0.01]).astype(np.float32)
                fb = dict(b, labels=torch.from_numpy(labels).to(dev))
                with config_changed(model, loss_type="bce"), \
                        config_changed(oracle, loss_type="bce"):
                    entry["loss_bce"] = run(model, fb)[0]
                    entry["loss_bce_f32"] = run(oracle, fb)[0]
            others[name] = entry
            losses = [v for k, v in entry.items() if k.startswith("loss")]
            check(ran["K3"] == 12 and ran["K4"] == 12 and idle(ran, ("K3", "K4"))
                  and entry["gap"] <= FT_LOGIT_TOL and np.isfinite(losses).all(),
                  f"{name} forward: launches {ran}, gap {entry['gap']}, "
                  f"losses {losses}")
            check(all(e > FT_LOGIT_TOL for e in entry["fault_gaps"].values()),
                  f"{name} forward: a fault passes {entry['fault_gaps']}")
            del model, oracle
        out["ft_heads"] = others

        # --- (f) sweep --task gqa: shots 1 2 x seeds 0 1, one epoch each,
        # through gqa_cpt --model_variant ft at SWEEP_LAYERS, then
        # fewshot_eval over its pickles
        t0 = time.perf_counter()
        results = sweep.main(
            ["--task", "gqa", "--shots", "1", "2", "--seeds", "0", "1",
             "--results_dir", f"{root}/sweep", "--stage2", "--"] + gqa_data
            + flags(SWEEP_LAYERS)
            + ["--num_train_epochs", "1", "--n_sample", "{shot}",
               "--random_seed", "{seed}", "--per_gpu_train_batch_size",
               "{batch}"])
        sweep_s = time.perf_counter() - t0
        report = fewshot_eval.main(["--results_dir", f"{root}/sweep"])
        pickles = sorted(os.listdir(f"{root}/sweep"))
        check(pickles == [f"gqa_shot{s}_seed{d}.pk" for s in (1, 2)
                          for d in (0, 1)]
              and {k: dict(v) for k, v in report.items()} == results
              and seed_sweep_report(report) == seed_sweep_report(results),
              f"sweep: pickles {pickles}, results {results}, report "
              f"{dict(report)}")
        out["sweep"] = {"results": results, "seconds": sweep_s,
                        "report": seed_sweep_report(results)}
    phase_s = time.perf_counter() - t_phase
    r, g = out["rec_ft"], out["gqa_ft"]
    print(f"phase 11 finetune baselines ({smi}) in {phase_s:.1f} s: REC_FT "
          f"training (flash, 16 x (70 + 50)) {len(rec.losses)} steps, "
          f"ms/step {out['rec_ft_train']['ms_per_step']:.2f} after the first "
          f"({rec.steps[0]['ms']:.1f}), losses {rec.losses[0]:.4f} -> "
          f"{rec.losses[-1]:.4f}, launches {out['rec_ft_train']['launches']}; "
          f"eval [64,120] {r['eval_ms']:.1f} ms, launches {r['launches']}, "
          f"gap to f32 {r['gap']:.3e} (REC_FT_SCORE_TOL {REC_FT_SCORE_TOL}), "
          f"scores {r['score_range'][0]:.4f}..{r['score_range'][1]:.4f}, faults "
          + ", ".join(f"{f} {e:.3e} ({e / REC_FT_SCORE_TOL:.1f}x tol)"
                      for f, e in r["fault_gaps"].items())
          + "; gradients vs f32 einsum (largest per-tensor relative L2, wqkv "
          "by q/k/v) " + ", ".join(f"{k} {e[0]:.4e} ({e[1]})"
                                   for k, e in r["gradient_gaps"].items())
          + f" (REC_FT_GRAD_TOL {REC_FT_GRAD_TOL}); GQA FT training {len(gq.losses)} calls, "
          f"ms/call {out['gqa_ft_train']['ms_per_call']:.2f}, losses "
          f"{gq.losses[0]:.4f} -> {gq.losses[-1]:.4f}; eval [128,90] "
          f"{g['eval_ms']:.1f} ms, launches {g['launches']}, gap to f32 "
          f"{g['gap']:.3e} of {g['logit_scale']:.3f} (GQA_FT_LOGIT_TOL "
          f"{GQA_FT_LOGIT_TOL}), faults "
          + ", ".join(f"{f} {e:.3e} ({e / GQA_FT_LOGIT_TOL:.1f}x tol)"
                      for f, e in g["fault_gaps"].items())
          + f", --save_dir reload bit-equal {g['save_dir_bit_equal']}; VCR FT "
          f"training {len(out['vcr_ft_train']['losses'])} steps, ms/step "
          f"{out['vcr_ft_train']['ms_per_step']:.2f}; "
          + "; ".join(f"{k}: {e['ms']:.1f} ms, gap to f32 {e['gap']:.3e}, "
                      "faults " + ", ".join(
                          f"{f} {x:.3e} ({x / VCR_FT_SCORE_TOL:.1f}x tol)"
                          for f, x in e["fault_gaps"].items())
                      + f", scores {e['score_range'][0]:.4f}.."
                      f"{e['score_range'][1]:.4f}"
                      for k, e in out["vcr_ft"]["runs"].items())
          + f" (VCR_FT_SCORE_TOL {VCR_FT_SCORE_TOL}); heads "
          + "; ".join(f"{k}: gap {e['gap']:.3e}, faults " + ", ".join(
                          f"{f} {x:.3e} ({x / FT_LOGIT_TOL:.1f}x tol)"
                          for f, x in e["fault_gaps"].items())
                      + ", losses " + ", ".join(
                          f"{n} {x:.4f}" for n, x in e.items()
                          if n.startswith("loss"))
                      for k, e in out["ft_heads"].items())
          + f" (FT_LOGIT_TOL {FT_LOGIT_TOL}); sweep (4 runs, {SWEEP_LAYERS} "
          f"layers) {out['sweep']['seconds']:.1f} s", flush=True)
    print(out["sweep"]["report"], flush=True)
    if failed:
        raise AssertionError(f"phase 11: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 12. The keys of the reference's sgg_configs/vgattr/vinvl_x152c4.yaml
# that the port maps (the reference tree is not in the repository): the
# R-152-C4 32x8d body, the RPN's and box head's test sizes, the 1595 / 525
# VG vocabularies, the 600/1000 test sizes and VinVL's pixel means.
VINVL_YAML = """\
MODEL:
  META_ARCHITECTURE: "AttrRCNN"
  BACKBONE:
    CONV_BODY: "R-152-C4"
  RESNETS:
    BACKBONE_OUT_CHANNELS: 1024
    STRIDE_IN_1X1: False
    NUM_GROUPS: 32
    WIDTH_PER_GROUP: 8
  RPN:
    PRE_NMS_TOP_N_TEST: 6000
    POST_NMS_TOP_N_TEST: 300
  ROI_HEADS:
    BATCH_SIZE_PER_IMAGE: 384
    POSITIVE_FRACTION: 0.5
    SCORE_THRESH: 0.2
    DETECTIONS_PER_IMG: 100
    MIN_DETECTIONS_PER_IMG: 10
  ROI_BOX_HEAD:
    NUM_CLASSES: 1595
  ROI_ATTRIBUTE_HEAD:
    NUM_ATTRIBUTES: 525
    POSTPROCESS_ATTRIBUTES_THRESHOLD: 0.05
  ATTRIBUTE_ON: True
INPUT:
  MIN_SIZE_TEST: 600
  MAX_SIZE_TEST: 1000
  PIXEL_MEAN: [103.530, 116.280, 123.675]
DATASETS:
  LABELMAP_FILE: "visualgenome/VG-SGG-dicts-vgoi6-clipped.json"
  TRAIN: ("visualgenome/train_vgoi6_clipped.yaml",)
  TEST: ("visualgenome/test_vgoi6_clipped.yaml",)
DATALOADER:
  NUM_WORKERS: 0
SOLVER:
  BASE_LR: 0.01
  WEIGHT_DECAY: 0.0001
  MAX_ITER: 90000
  STEPS: (49000, 65000)
  IMS_PER_BATCH: 8
  CHECKPOINT_PERIOD: 10000
TEST:
  IMS_PER_BATCH: 8
  SKIP_PERFORMANCE_EVAL: True
  SAVE_PREDICTIONS: True
  SAVE_RESULTS_TO_TSV: True
  TSV_SAVE_SUBSET: ['rect', 'class', 'conf', 'feature']
  GATHER_ON_CPU: True
OUTPUT_DIR: "./output/X152C5_test"
DATA_DIR: "./datasets"
"""
# the opts of every RefCOCO command of the reference (refcoco_val.sh:5-18)
REFCOCO_OPTS = (
    "TEST.IMS_PER_BATCH", "8",
    "MODEL.RPN.FORCE_BOXES", "True",
    "MODEL.ROI_BOX_HEAD.FORCE_BOXES", "True",
    "MODEL.WEIGHT", "models/vinvl/vinvl_vg_x152c4.pth",
    "MODEL.ROI_HEADS.NMS_FILTER", "2",
    "MODEL.ROI_HEADS.SCORE_THRESH", "0.2",
    "DATASETS.TEST", '("RefCoCoDataset",)',
    "DATA_DIR", "data/refcoco/yamls/refcoco_val.yaml",
    "MODEL.CLS_AGNOSTIC_BBOX_REG", "False",
    "MODEL.ATTRIBUTE_ON", "True",
    "TEST.OUTPUT_FEATURE", "True",
    "OUTPUT_DIR", "./output/refcoco/cpt",
)
# the detector tools' opts: the post-processor and threshold of
# VINVL_X152C4 (the detect step of phase 4), and the plain-image dataset
# class of the reference's uncolored pass (cmds/gqa/_ext.sh)
DETECTOR_OPTS = ("MODEL.ROI_HEADS.NMS_FILTER", "2",
                 "MODEL.ROI_HEADS.SCORE_THRESH", "0.2",
                 "DATASETS.TEST", "('ImgDataset',)")
DETECTOR_IMAGES = 4
DETECTOR_LABELMAP = {
    "label_to_idx": {n: i + 1 for i, n in enumerate(
        ("person", "dog", "car", "tree", "chair"))},
    "attribute_to_idx": {n: i + 1 for i, n in enumerate(
        ("red", "tall", "wooden", "white", "small", "furry"))},
}


def resolves_to_vinvl(ref) -> bool:
    """The reference yaml with refcoco_val.sh's opts resolves to the port's
    VINVL_X152C4 field for field (force-boxes extraction on, features out)."""
    from cpt_tpu_torch.models.detector.config import VINVL_X152C4

    return (all(getattr(ref.detector, part) == getattr(VINVL_X152C4, part)
                for part in ("backbone", "rpn", "roi_heads", "attributes",
                             "input"))
            and ref.detector.force_boxes and ref.detector.output_feature
            and ref.attribute_on and not ref.relation_on
            and ref.conv_body == "R-152-C4"
            and ref.datasets_test == ("RefCoCoDataset",))


def detector_tsv(root: str, size: int, n: int = DETECTOR_IMAGES) -> str:
    """A VG-TSV of ``n`` random ``size × size`` images, each with 3-6 boxes
    of DETECTOR_LABELMAP's classes and 0-3 attributes, written by the
    port's ``write_detection_tsv`` → its yaml."""
    from cpt_tpu_torch.data.vg_tsv import write_detection_tsv

    rng = np.random.RandomState(12)
    names = list(DETECTOR_LABELMAP["label_to_idx"])
    attrs = list(DETECTOR_LABELMAP["attribute_to_idx"])
    images, labels = {}, {}
    for i in range(n):
        images[f"img{i}"] = rng.randint(0, 256, (size, size, 3)).astype(
            np.uint8)
        objects = []
        for _ in range(rng.randint(3, 7)):
            xy = rng.uniform(0, size * 0.7, 2)
            wh = rng.uniform(size * 0.05, size * 0.3, 2)
            objects.append({
                "rect": [float(v) for v in np.concatenate([xy, xy + wh])],
                "class": names[rng.randint(len(names))],
                "attributes": [attrs[j] for j in rng.choice(
                    len(attrs), rng.randint(0, 4), replace=False)]})
        labels[f"img{i}"] = {"objects": objects}
    return write_detection_tsv(root, "attr", images, labels, DETECTOR_LABELMAP)


# The fields each random draw reads: a draw is shared by every config that
# agrees on them (a precision, a test-time setting, a task head, dropout
# and the heads' count are not read).
DETECTOR_DRAW_FIELDS = (
    lambda c: c.backbone.stage_blocks, lambda c: c.backbone.head_blocks,
    lambda c: c.backbone.num_groups, lambda c: c.backbone.width_per_group,
    lambda c: c.backbone.stem_out_channels,
    lambda c: c.backbone.res2_out_channels, lambda c: c.rpn.num_anchors,
    lambda c: c.roi_heads.num_classes, lambda c: c.attributes.cls_emd_dim,
    lambda c: c.attributes.attr_emd_dim, lambda c: c.attributes.num_attributes)
OSCAR_DRAW_FIELDS = ("hidden_size", "intermediate_size", "vocab_size",
                     "max_position_embeddings", "type_vocab_size",
                     "img_feature_type", "img_feature_dim", "code_voc",
                     "code_dim", "code_size")


def first_layers(sd: dict, n: int) -> dict:
    """An Oscar-layout state dict cut to its first ``n`` encoder layers."""
    return {k: v for k, v in sd.items()
            if not (k.startswith("bert.encoder.layer.")
                    and int(k.split(".")[3]) >= n)}


@contextlib.contextmanager
def cached_random_weights():
    """Within the block, every tool draws its random reference-layout
    weights (X152-C4's and Oscar's) once per geometry and seed: the numpy
    draw takes seconds and most phases build several models on the same
    seed. A geometry is the fields the draw reads (``DETECTOR_DRAW_FIELDS``,
    ``OSCAR_DRAW_FIELDS``), and an Oscar draw of fewer layers is the first
    layers of a deeper one (``random_oscar_state_dict`` draws the layers in
    order after every other tensor, a discrete-code table excepted). Each
    call gets its own dict of the shared arrays. A draw in flight on another
    thread (``predraw_weights``) is awaited, not repeated. Yields the log of
    the draws made: (thread name, which, seconds)."""
    from cpt_tpu_torch.models.detector import convert as dconv
    from cpt_tpu_torch.utils import convert as cv

    real_vinvl = dconv.random_vinvl_state_dict
    real_oscar = cv.random_oscar_state_dict
    lock, drawn, log = threading.Lock(), {}, []

    def draw_once(draw, key, layers, shallower, cfg, seed, what):
        """``draw(cfg, seed)`` unless a draw under ``key`` of ``layers``
        (or, where ``shallower``, of more layers) is cached or in flight."""
        with lock:
            entries = drawn.setdefault(key, [])
            done = next((f for n, f in entries if n == layers
                         or (shallower and n >= layers)), None)
            owner = done is None
            if owner:
                done = concurrent.futures.Future()
                entries.append((layers, done))
        if owner:
            t0 = time.perf_counter()
            try:
                done.set_result(draw(cfg, seed))
            except BaseException as e:
                done.set_exception(e)
                raise
            log.append((threading.current_thread().name, what,
                        time.perf_counter() - t0))
        sd = done.result()
        return dict(sd) if layers is None else first_layers(sd, layers)

    def vinvl(cfg, seed=0):
        key = ("vinvl", seed, tuple(f(cfg) for f in DETECTOR_DRAW_FIELDS))
        return draw_once(real_vinvl, key, None, False, cfg, seed,
                         f"X152 classes {cfg.roi_heads.num_classes} seed {seed}")

    def oscar(cfg, seed=0):
        key = ("oscar", seed, tuple(getattr(cfg, f) for f in OSCAR_DRAW_FIELDS))
        return draw_once(real_oscar, key, cfg.num_hidden_layers,
                         not cfg.img_feature_type.startswith("dis_code"), cfg,
                         seed, f"Oscar {cfg.num_hidden_layers}x{cfg.hidden_size} "
                         f"{cfg.img_feature_type} {cfg.img_feature_dim} seed {seed}")

    dconv.random_vinvl_state_dict, cv.random_oscar_state_dict = vinvl, oscar
    try:
        yield log
    finally:
        dconv.random_vinvl_state_dict = real_vinvl
        cv.random_oscar_state_dict = real_oscar


@contextlib.contextmanager
def timed_detect_steps(module, counters, steps: list):
    """``module.make_detect_fn``'s functions record each call's host ms
    (ending in a synchronise) and kernel launches into ``steps``."""
    import torch

    real = module.make_detect_fn

    def make(*a, **kw):
        fn = real(*a, **kw)

        def step(*args):
            before = {k: c.launches for k, c in counters.items()}
            t = time.perf_counter()
            out = fn(*args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t) * 1e3,
                          "launches": {k: c.launches - before[k]
                                       for k, c in counters.items()},
                          "fn": fn, "args": args})
            return out
        return step

    module.make_detect_fn = make
    try:
        yield
    finally:
        module.make_detect_fn = real


SEG_RESIZE_IMAGES = 2
SEG_RESIZE_DETS = 3


def seg_resize_extract(root: str, flags: list, counters, tiny: bool) -> dict:
    """``extract_features --resize`` over SEG_RESIZE_IMAGES RefCOCO images
    whose SEG_RESIZE_DETS dets carry RLE ellipse masks (``"height"`` given,
    so the masks rescale with the image) → readings."""
    from cpt_tpu_torch.tools import extract_features
    from cpt_tpu_torch.utils import rle
    from cpt_tpu_torch.utils.image_codec import write_image
    from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature

    h, w = (48, 64) if tiny else (480, 640)
    os.makedirs(root)
    rng = np.random.RandomState(2034)
    anns, dets = [], {}
    for q in range(SEG_RESIZE_IMAGES):
        name = f"COCO_val2014_{q + 1:012d}.jpg"
        write_image(f"{root}/{name}",
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        anns.append({"id": f"seg{q}", "caption": "the red thing",
                     "file_name": name, "height": h})
        xy = rng.uniform(0, 0.6, (SEG_RESIZE_DETS, 2)) * [w, h]
        wh = rng.uniform(0.1, 0.4, (SEG_RESIZE_DETS, 2)) * [w, h]
        boxes = np.round(np.concatenate([xy, xy + wh], 1))
        dets[str(q + 1)] = [
            {"box": [float(b[0]), float(b[1]), float(b[2] - b[0] + 1),
                     float(b[3] - b[1] + 1)], "rle": rle.encode(m)}
            for b, m in zip(boxes, ellipse_masks(boxes, (h, w)))]
    for name, obj in (("ann", anns), ("det", dets)):
        with open(f"{root}/{name}.json", "w") as f:
            json.dump(obj, f)
    zero_counts(counters)
    t = time.perf_counter()
    extract_features.main(flags + [
        "--task", "refcoco", "--ann_file", f"{root}/ann.json",
        "--det_file", f"{root}/det.json",
        "--image_root", root, "--resize", "--copies_per_chunk", "4",
        "--output", f"{root}/seg.tsv"])
    seconds = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    tsv = TSVFile(f"{root}/seg.tsv")
    rows = [json.loads(tsv.seek(i)[1])["objects"] for i in range(len(tsv))]
    tsv.close()
    feats = [decode_feature(b["feature"]) for objs, *_ in rows
             for copy in objs for b in copy]
    return {"shape": [h, w], "rows": len(rows),
            "copies": [len(objs) for objs, *_ in rows], "seconds": seconds,
            "finite": bool(feats) and all(np.isfinite(f).all() for f in feats),
            "launches": launches}


def run_detector_tools(res, counters, detect_launches: list,
                       tiny: bool = False) -> dict:
    """Phase 12 (see the module docstring) through the detector tools'
    ``main``s on phase 4's detector configuration, with their own random
    weights (seed 0). ``detect_launches``: the launches of phase 4's detect
    steps. ``tiny``: the tools take ``--tiny`` in place of the reference
    yaml (a dry run of the code paths on the CPU; the launch checks fail
    there). Gathers every reading, prints it, then raises on the first
    check that failed."""
    import torch

    from cpt_tpu_torch.models.detector.yacs_bridge import load_reference_yaml
    from cpt_tpu_torch.tools import cpt_predict as cp
    from cpt_tpu_torch.tools import extract_features, test_detector
    from cpt_tpu_torch.utils.image_codec import read_image, write_image
    from cpt_tpu_torch.utils.tsv import TSVFile, decode_feature

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    dev = res.device.type
    common = ["--device", dev, "--dtype",
              "bfloat16" if res.detector.dtype == torch.bfloat16 else "float32"]
    out = {}
    with tempfile.TemporaryDirectory() as root, cached_random_weights():
        yaml_path = f"{root}/vinvl_x152c4.yaml"
        with open(yaml_path, "w") as f:
            f.write(VINVL_YAML)
        ref = load_reference_yaml(yaml_path, list(REFCOCO_OPTS))
        check(resolves_to_vinvl(ref), "vinvl yaml + refcoco opts != "
                                      "VINVL_X152C4")
        cfg_flags = (["--tiny"] if tiny else
                     ["--config_file", yaml_path, "--opts", *DETECTOR_OPTS])
        size = (load_reference_yaml(yaml_path, list(DETECTOR_OPTS))
                .detector.input.pad_h if not tiny else 64)

        # test_detector over --synthetic images: VOC and COCO metrics, one
        # --expected_results met
        steps: list = []
        zero_counts(counters)
        meet = json.dumps([["mAP", 0.5, 0.51]])      # 0 <= mAP <= 1 meets it
        with timed_detect_steps(test_detector, counters, steps):
            results, ok_meet = test_detector.main(
                cfg_flags + common + ["--synthetic", str(DETECTOR_IMAGES),
                                      "--coco_eval", "--expected_results",
                                      meet, "--output", f"{root}/det.pk"])
        launches = {k: c.launches for k, c in counters.items()}
        try:
            paths = k1_paths(counters, launches, "test_detector")
        except AssertionError as e:
            paths = dict(counters["K1"].path_launches)
            check(False, str(e))
        with open(f"{root}/det.pk", "rb") as f:
            preds = pickle.load(f)["predictions"]
        want = {k: max(d[k] for d in detect_launches) if detect_launches
                else 1 for k in ("K1", "K2", "K5")}
        for i, st in enumerate(steps):
            check(all(st["launches"][k] >= n for k, n in want.items()),
                  f"test_detector image {i}: launches {st['launches']}, "
                  f"phase 4's detect step {want}")
        check(len(steps) == DETECTOR_IMAGES, f"{len(steps)} detect steps")
        metrics = ("mAP", "coco_AP", "coco_AP50", "coco_AP75")
        check(all(np.isfinite(results[m]) for m in metrics),
              f"metrics {results}")
        check(ok_meet is True, f"--expected_results {meet} not met")
        check(all(len(p["boxes"]) and np.isfinite(p["boxes"]).all()
                  and np.isfinite(p["scores"]).all() for p in preds),
              "empty or non-finite detections")
        profile = (profiled(lambda: steps[-1]["fn"](*steps[-1]["args"]),
                            "test_detector's detect step")
                   if dev == "cuda" else {})
        ms = [st["ms"] for st in steps]
        out["test_detector"] = {
            "results": {m: results[m] for m in metrics}, "ok": ok_meet,
            "ms_per_image": ms, "launches": launches, "k1_paths": paths,
            "image_launches": [st["launches"] for st in steps],
            "profile": profile}
        print(f"test_detector --config_file vinvl_x152c4.yaml --opts "
              f"{' '.join(DETECTOR_OPTS)} --synthetic {DETECTOR_IMAGES} "
              f"--coco_eval: mAP {results['mAP']:.4f}, COCO AP "
              f"{results['coco_AP']:.4f} AP50 {results['coco_AP50']:.4f} "
              f"AP75 {results['coco_AP75']:.4f}; host ms per image "
              + ", ".join(f"{x:.2f}" for x in ms)
              + f"; launches per image {steps[-1]['launches']} (phase 4's "
              f"detect step {want}); K1 by path {paths}", flush=True)

        # the same run with an --expected_results it misses
        miss = json.dumps([["mAP", 2.0, 0.5]])       # 1.5 < mAP < 2.5
        _, ok_miss = test_detector.main(
            cfg_flags + common + ["--synthetic", str(DETECTOR_IMAGES),
                                  "--expected_results", miss])
        check(ok_miss is False, f"--expected_results {miss} met")
        out["expected_results"] = {"meet": ok_meet, "miss": ok_miss}
        print(f"--expected_results {meet}: ok {ok_meet}; {miss}: ok "
              f"{ok_miss}", flush=True)

        # --attr_eval over a VG-TSV written by write_detection_tsv
        tsv_yaml = detector_tsv(f"{root}/tsv", size)
        zero_counts(counters)
        t = time.perf_counter()
        attr = test_detector.main(cfg_flags + common + [
            "--tsv", tsv_yaml, "--attr_eval"])
        attr_s = time.perf_counter() - t
        attr_l = {k: c.launches for k, c in counters.items()}
        check(np.isfinite(attr["attr_mAP"])
              and np.isfinite(attr["attr_weighted_mAP"]), f"attr {attr}")
        check(attr_l["K1"] > 0 and attr_l["K2"] > 0 and attr_l["K5"] == 0,
              f"attr eval launches {attr_l}")
        out["attr_eval"] = {"attr_mAP": attr["attr_mAP"],
                            "attr_weighted_mAP": attr["attr_weighted_mAP"],
                            "seconds": attr_s, "launches": attr_l}
        print(f"test_detector --attr_eval over a {DETECTOR_IMAGES}-image "
              f"VG-TSV: attr mAP {attr['attr_mAP']:.6f} (weighted "
              f"{attr['attr_weighted_mAP']:.6f}) in {attr_s:.2f} s "
              f"(set-up included); launches {attr_l}", flush=True)

        # extract_features --image_dir over the synthetic images as
        # quality-95 .jpg files: rows against test_detector's detect step
        # run on each file's decoded pixels
        img_dir = f"{root}/images"
        os.makedirs(img_dir)
        rng = np.random.RandomState(0)               # test_detector's draw
        decoded = []
        for i in range(DETECTOR_IMAGES):
            write_image(f"{img_dir}/syn{i}.jpg", rng.randint(
                0, 256, (size, size, 3)).astype(np.uint8), quality=95)
            decoded.append(read_image(f"{img_dir}/syn{i}.jpg"))
        zero_counts(counters)
        ext = extract_features.main(cfg_flags + common + [
            "--image_dir", img_dir, "--output", f"{root}/plain.tsv"])
        ext_l = {k: c.launches for k, c in counters.items()}
        on_files = []
        for st, img in zip(steps, decoded):
            fn, (canvas, anchors, hw) = st["fn"], st["args"]
            _, boxes, _, _, valid, _ = fn(
                torch.from_numpy(img).to(canvas.device), anchors, hw)
            on_files.append({"boxes": boxes[valid].cpu().numpy()})
        tsv = TSVFile(f"{root}/plain.tsv")
        rows = [tsv.seek(i) for i in range(len(tsv))]
        tsv.close()
        keys = [k for k, _ in rows]
        check(keys == [f"syn{i}" for i in range(DETECTOR_IMAGES)],
              f"--image_dir keys {keys}")
        gaps, feat_dim = [], cp.region_feature_dim(res.det_cfg)
        for (_key, row), p in zip(rows, on_files):
            objs = json.loads(row)["objects"]
            rects = np.asarray([o["rect"] for o in objs], np.float32)
            feats = np.stack([decode_feature(o["feature"]) for o in objs])
            same = rects.shape == p["boxes"].shape and np.array_equal(
                rects, p["boxes"].astype(np.float32))
            gaps.append(float(np.abs(rects - p["boxes"]).max())
                        if rects.shape == p["boxes"].shape else np.inf)
            check(same and feats.shape == (len(objs), feat_dim)
                  and np.isfinite(feats).all(),
                  f"--image_dir row {_key}: rects {rects.shape} vs "
                  f"{p['boxes'].shape}, largest gap {gaps[-1]}")
        check(ext_l["K1"] > 0 and ext_l["K2"] > 0 and ext_l["K5"] > 0,
              f"--image_dir launches {ext_l}")
        out["image_dir"] = {"images": ext.get("images"),
                            "seconds": ext.get("seconds"),
                            "rect_gaps": gaps, "launches": ext_l}
        print(f"extract_features --image_dir ({DETECTOR_IMAGES} .jpg): "
              f"{ext.get('images')} rows in {ext.get('seconds', 0):.2f} s; "
              f"rects against test_detector's detect step on the decoded "
              f"files, largest gap "
              f"per image {gaps}; launches {ext_l}", flush=True)

        # extract_features --resize over RefCOCO SEG images (quality-75
        # .jpg files; 480x640, or 48x64 at the tiny size) whose dets carry
        # RLE masks: the image (bilinear) and the masks (nearest) rescale by
        # the 600/1000 rule through utils/image_ops; K1 50 and K2 1 an image
        out["resize_extract"] = seg_resize_extract(
            f"{root}/seg", (["--tiny"] if tiny else []) + common, counters, tiny)
        r = out["resize_extract"]
        check(r["rows"] == SEG_RESIZE_IMAGES and r["finite"]
              and r["copies"] == [SEG_RESIZE_DETS] * SEG_RESIZE_IMAGES,
              f"extract_features --resize with SEG masks: {r}")
        check(r["launches"]["K1"] == 50 * SEG_RESIZE_IMAGES
              and r["launches"]["K2"] == SEG_RESIZE_IMAGES
              and r["launches"]["K5"] == 0,
              f"extract_features --resize launches {r['launches']}")
        print(f"extract_features --resize over {SEG_RESIZE_IMAGES} SEG images "
              f"({r['shape'][0]}x{r['shape'][1]}, {SEG_RESIZE_DETS} RLE masks "
              f"each): {r['rows']} rows, copies {r['copies']}, finite "
              f"{r['finite']}, in {r['seconds']:.2f} s (set-up included); "
              f"launches {r['launches']}", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 12 took {phase_s:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 12: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 13: the Oscar classification runners (VQA, GQA, NLVR2, retrieval)
# at full width on synthetic 2054-d region features. Named faults each
# tolerance must see: the classifier's output bias dropped (every runner),
# NLVR2's two choices swapped, retrieval's 3-D CL mask replaced by the 2-D
# CLR one, and softmax column 0 read as the match score instead of column 1.
OSCAR_FAULTS = {"vqa": ("cls_bias_dropped",), "gqa": ("cls_bias_dropped",),
                "nlvr_pair": ("cls_bias_dropped", "choices_swapped"),
                "nlvr_concat": ("cls_bias_dropped",),
                "retrieval": ("cls_bias_dropped", "column_0"),
                "retrieval_rerank": ("column_0",),
                "retrieval_cl": ("mask_2d", "column_0")}
# The fresh heads' biases are zero (flax's init), and a few steps at the
# runners' learning rate move them by ~1e-4, so a dropped bias could not be
# seen: the phase draws each classifier bias from N(0, OSCAR_BIAS_STD²)
# (seed 0) over the head the tool built, before it trains.
OSCAR_BIAS_STD = 0.5
# Phase 13's tolerances, one a runner, bf16 on the card under "auto"
# against the f32 einsum path on the same weights rounded to bf16: VQA /
# GQA / NLVR2 logits as the largest |Δ| over the largest |logit|,
# retrieval's match scores (in [0, 1]) as the largest |Δ|. Each is set from
# the calibration run (H100 80GB HBM3, 700 W; phase 13 alone) as phase
# 11's were set: at most 3× the largest sound gap of the runner's runs, and
# the geometric mean of that gap and the smallest fault's where lower.
# VQA: bf16 6.076e-3, the dropped bias 0.6292; 1.8e-2 (3×). GQA: 6.063e-3,
# 0.6111; 1.8e-2. NLVR2: pair 6.442e-3, concat 2.150e-2, the swapped
# choices 0.1077 (the dropped bias 0.6502 / 2.284); 4.8e-2, the geometric
# mean (2.2× either way). Retrieval: full 7.512e-4, re-rank 1.857e-3, CL
# 2.187e-4; the 2-D mask 4.009e-3, column 0 0.699-0.985, the dropped bias
# 0.1073; 2.7e-3, the geometric mean (1.45× and 1.48×).
OSCAR_TOL = {"vqa": 1.8e-2, "gqa": 1.8e-2, "nlvr": 4.8e-2, "retrieval": 2.7e-3}
# Each named fault must also lie farther than this many times the run's own
# gap: a tolerance shared by variants is set by the loosest, so the CL
# mask's 2-D fault (4.009e-3 in the calibration) clears 2.7e-3 by 1.48×
# only, against CL's own gap of 2.187e-4 (18×).
OSCAR_FAULT_MARGIN = 5.0
# phase 13 runs the runners at this depth of Oscar-base's 12 (full width):
# phase 22 pushed the whole script past 480 s (523.1 s with phase 13 at 12
# layers, 39.2-40.5 s of it). Phase 13 alone (H100 80GB HBM3, 700 W): 51.1
# s at 12 layers, 32.4 s at 6. The tolerances above, set at 12 layers,
# hold at 6 (whole runs of the script, same card): sound gaps VQA 5.804e-3,
# GQA 5.985e-3, NLVR2 pair 1.253e-2 and concat 8.609e-3, retrieval
# 7.293e-4, re-rank 1.316e-4, CL 1.578e-4 (each ≤ 1/3 of its tolerance);
# the thinnest faults retrieval CL's 2-D mask 4.303e-3 (1.6x) and NLVR2's
# swapped choices 9.715e-2 (2.0x), against 1.48x and 2.2x at 12 layers.
OSCAR_LAYERS = 6
OSCAR_WORDS = ("man", "woman", "dog", "cat", "person", "car", "tree", "shirt",
               "table", "chair", "horse", "bus")


def oscar_fixture(root: str, dim: int, seed: int = 2033) -> dict:
    """The phase's files: a predictions TSV of 16 images (``im0`` ..
    ``im15``), 50 regions each of ``dim``-d features (ReLU-like at four
    scales, 0.25 to 2, so that images differ for the random encoder: the
    swapped choices and the 2-D mask move its outputs; the last 6 a box's
    geometry) with od labels; VQA's 16 training, 64 val and 8 test
    questions (1-3 soft labels under 1853, so GQA reads them too) and its
    answer list; NLVR2's 16 training and 64 val statements over image
    pairs; retrieval's one caption for each of the first 8 images and 8
    candidates an image (every image's caption, its own first)."""
    from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(16):
        f = np.abs(rng.randn(50, dim)).astype(np.float32) * 0.25 * 2 ** (i % 4)
        f[:, -6:] = rng.rand(50, 6)
        rows.append([f"im{i}", json.dumps({"objects": [
            {"rect": [0, 0, 10, 10], "conf": 0.9,
             "class": OSCAR_WORDS[rng.randint(len(OSCAR_WORDS))],
             "feature": encode_feature(x)} for x in f]})])
    p = {"feat_file": f"{root}/oscar.tsv"}
    tsv_writer(rows, p["feat_file"])

    def dump(name, obj):
        p[name] = f"{root}/oscar_{name}.json"
        with open(p[name], "w") as f:
            json.dump(obj, f)

    def words(n):
        return " ".join(OSCAR_WORDS[j] for j in rng.randint(len(OSCAR_WORDS),
                                                             size=n))

    def questions(n, first, labeled=True):
        return [{"q_id": str(first + q), "img_id": f"im{rng.randint(16)}",
                 "question": f"what is the {words(rng.randint(1, 8))} on the "
                             f"left ?",
                 **({"label_scores": {str(a): float(s) for a, s in zip(
                     rng.choice(1853, 1 + q % 3, replace=False),
                     rng.choice([0.3, 0.6, 0.9, 1.0], 1 + q % 3))}}
                    if labeled else {})} for q in range(n)]

    dump("vqa_train", questions(16, 0))
    dump("vqa_val", questions(64, 1000))
    dump("vqa_test", questions(8, 2000, labeled=False))
    dump("label2ans", [f"answer{i}" for i in range(3129)])

    def statements(n):
        return [{"ex_id": f"e{q}", "img_left": f"im{rng.randint(16)}",
                 "img_right": f"im{rng.randint(16)}",
                 "statement": f"there is a {words(rng.randint(1, 6))} in the "
                              f"left image", "label": int(rng.randint(2))}
                for q in range(n)]

    dump("nlvr_train", statements(16))
    dump("nlvr_val", statements(64))
    dump("captions", {f"im{i}": [f"a {words(rng.randint(2, 10))} near the "
                                 f"{words(1)}"] for i in range(8)})
    dump("cand", {f"im{i}": [[f"im{i}", 0]] + [[f"im{j}", 0] for j in range(8)
                                               if j != i] for i in range(8)})
    return p


def draw_biases(model) -> None:
    """``model``'s classifier biases drawn from N(0, OSCAR_BIAS_STD²), seed
    0, over the fresh head its runner built."""
    import torch

    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name in ("cls_hidden", "cls_out"):
            layer = getattr(model, name, None)
            if layer is not None:
                layer.bias.copy_(torch.randn(layer.bias.shape, generator=g)
                                 * OSCAR_BIAS_STD)


@contextlib.contextmanager
def oscar_fault(fault: str, data):
    """``data`` with one of phase 13's named input faults:
    ``choices_swapped`` (NLVR2's pair batches with choice 0 and 1
    exchanged) or ``mask_2d`` (retrieval tensorized with the 2-D CLR mask
    in place of its 3-D one)."""
    if fault == "choices_swapped":
        real = data.batch

        def swapped(indices, pad_to=None):
            *arrays, labels = real(indices, pad_to=pad_to)
            return (*(np.ascontiguousarray(a[:, ::-1]) for a in arrays), labels)

        data.batch = swapped
        try:
            yield
        finally:
            del data.batch
    elif fault == "mask_2d":
        kind, data.att_mask_type = data.att_mask_type, "CLR"
        try:
            yield
        finally:
            data.att_mask_type = kind
    else:
        raise ValueError(f"unknown phase 13 fault {fault!r}")


def cache_features(data) -> None:
    """Memoize ``data``'s feature reads (``features_for`` / ``_feats``):
    the comparisons after a runner's own run (the f32 model, the faults)
    then do not decode the TSV again."""
    import functools

    for name in ("features_for", "_feats"):
        if hasattr(data, name):
            setattr(data, name, functools.lru_cache(maxsize=None)(
                getattr(data, name)))


def run_oscar_runners(counters, smi: str, rows: list, dev, dt, bcfg) -> dict:
    """Phase 13 (see the module docstring): the four runners' ``main``s at
    the width of ``bcfg`` (Oscar-base on the card), each from one random
    Oscar-layout checkpoint (seed 0) with its fresh head (seed 0, biases
    drawn by ``draw_biases``). Gathers every reading, prints it, then
    raises on the first check that failed."""
    import torch

    from cpt_tpu_torch.tools import run_gqa, run_nlvr, run_retrieval, run_vqa
    from cpt_tpu_torch.utils import convert as cv

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    # the kernels at the runners' eval shapes: VQA's [64, 128 + 50] and
    # NLVR2's concat batch [64, 55 + 2 × 40] (K3's core streams S 178 and
    # S 135 past its 64-key tiles, ragged at 50 and 7) and NLVR2's pair
    # batch [2 × 64, 55 + 40]
    if dev.type == "cuda":
        for b, s_len in ((64, 178), (128, 95), (64, 135)):
            check_k3(rows, b, s_len)
            check_k4(rows, b * s_len)

    flags = ["--device", dev.type, "--dtype",
             "bfloat16" if dt == torch.bfloat16 else "float32", "--hidden_size",
             str(bcfg.hidden_size), "--num_hidden_layers",
             str(bcfg.num_hidden_layers), "--img_feature_dim",
             str(bcfg.img_feature_dim), "--seed", "0"]
    out = {}

    def drive(module, evals, entry, argv):
        """Run ``entry.main(argv)`` driven (``module`` is the one whose
        functions it calls: run_gqa runs run_vqa's), its heads' biases
        drawn; → (result, its Driven, the launches of the whole run)."""
        with Driven(module, evals, counters, build=draw_biases) as drv:
            result = entry.main(argv + flags)
        return result, drv, drv.total()

    layers = bcfg.num_hidden_layers

    def per_batch(call, n_rows, k3=True):
        """The eval call's launches fit one batch of 64 rows: K3 (unless
        ``k3`` is False) and K4 one a layer a batch, no other kernel."""
        n = -(-n_rows // 64)
        want = {k: 0 for k in counters}
        want.update({"K3": layers * n * k3, "K4": layers * n})
        return call["launches"] == want

    def steps_ok(rec, n_steps):
        return (len(rec.steps) == n_steps
                and all(np.isfinite(s["loss"]) for s in rec.steps)
                and all(not any(s["launches"].values()) for s in rec.steps))

    def compare(name, model, data, logits, run, scores=False):
        """The run's eval output (logits, or retrieval's match scores) and
        each named fault's against ``model``'s f32 einsum oracle, relative
        to the largest logit (absolute for scores), checked against the
        runner's OSCAR_TOL and against OSCAR_FAULT_MARGIN × the run's own
        gap. ``run(m)`` → ``m``'s eval logits on ``data``; the dropped bias
        and column 0 are read from the run's logits. Also read: the gap of
        ``model`` itself on the plain bf16 path (no kernel), which tells
        the kernels' share of the gap from bf16's."""
        def output(x):
            return run_retrieval.match_scores(x) if scores else x

        cache_features(data)
        kw = {"num_choices": 2} if hasattr(model, "num_choices") else {}
        want = output(run(ft_oracle(model, **kw)))
        with config_changed(model, attention_impl="einsum", ffn_impl="dense"):
            plain = output(run(model))
        bias = model.cls_out.bias.detach().float().cpu().numpy()
        faults = {}
        for fault in OSCAR_FAULTS[name]:
            if fault == "cls_bias_dropped":
                faults[fault] = output(logits - bias)
            elif fault == "column_0":
                faults[fault] = torch.softmax(torch.from_numpy(logits),
                                              -1)[:, 0].numpy()
            else:
                with oscar_fault(fault, data):
                    faults[fault] = output(run(model))
        got = output(logits)
        scale = 1.0 if scores else float(np.abs(want).max())
        gap = float(np.abs(got - want).max()) / scale
        faults = {f: float(np.abs(v - want).max()) / scale
                  for f, v in faults.items()}
        tol = OSCAR_TOL[name.split("_")[0]]
        check(gap <= tol and got.shape == want.shape,
              f"{name}: gap to f32 {gap} (tol {tol}), shapes {got.shape} "
              f"{want.shape}")
        check(all(e > max(tol, OSCAR_FAULT_MARGIN * gap)
                  for e in faults.values()),
              f"{name}: a fault passes {faults} (tol {tol}, gap {gap})")
        return {"gap": gap, "plain_gap": float(np.abs(plain - want).max())
                / scale, "fault_gaps": faults, "scale": scale, "tol": tol}

    def timings(rec, final, ran):
        return {"launches": ran, "losses": [s["loss"] for s in rec.steps],
                "ms_per_step": rec.ms_per_step(), "eval_ms_per_batch": final["ms"]}

    def step_text(rec):
        return [(s["loss"], s["launches"]) for s in rec.steps]

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fx = oscar_fixture(root, bcfg.img_feature_dim)
        ckpt = f"{root}/oscar.pth"
        # at the encoder geometry the runners build from the flags
        enc = run_vqa.model_config(run_vqa.build_args().parse_args(flags))
        torch.save({k: torch.from_numpy(v) for k, v in cv.random_oscar_state_dict(
            enc, seed=0).items()}, ckpt)
        flags += ["--checkpoint", ckpt]
        setup_s = time.perf_counter() - t0

        # --- (a) VQA: 2 epochs of 2 steps (batch 8), kl then bce from epoch
        # 1, eval on the 64 val questions after each epoch (the best kept,
        # checkpoint-{epoch} saved) and at the end, then the 8 test
        # questions' submission; (b) GQA (xe over 1853 answers): 1 epoch
        # of 2 steps, eval, the test-std rows
        vqa_common = ["--feat_file", fx["feat_file"], "--examples",
                      fx["vqa_train"], "--val_examples", fx["vqa_val"],
                      "--test_examples", fx["vqa_test"], "--label2ans",
                      fx["label2ans"], "--per_gpu_train_batch_size", "8"]
        for name, entry, extra, n_steps, n_calls, sub_name, keys in (
                ("vqa", run_vqa, ["--num_train_epochs", "2", "--eval_every",
                                  "1", "--loss_type", "kl", "--adjust_loss",
                                  "--adjust_loss_epoch", "1"], 4, 4,
                 "test2015_results.json", {"question_id", "answer"}),
                ("gqa", run_gqa, ["--num_labels", "1853",
                                  "--num_train_epochs", "1"], 2, 2,
                 "submission_results.json", {"questionId", "prediction"})):
            out_dir = f"{root}/{name}"
            acc, rec, ran = drive(run_vqa, ("evaluate",), entry, vqa_common + [
                "--output_dir", out_dir, "--output", f"{root}/{name}.pk"]
                + extra)
            model = rec.model
            final = [c for c in rec.calls if len(c["args"][0]) == 64][-1]
            data = final["args"][0]
            entry_out = compare(name, model, data, final["result"][2],
                                lambda m: run_vqa.evaluate(m, data, 64)[2])
            with open(f"{out_dir}/{sub_name}") as f:
                sub = json.load(f)
            with open(f"{root}/{name}.pk", "rb") as f:
                saved = pickle.load(f)
            want_dir = sorted(["checkpoint-1", "checkpoint-2", sub_name]
                              if name == "vqa" else [sub_name])
            check(steps_ok(rec, n_steps)
                  and model.config.loss_type == ("kl" if name == "vqa" else "xe"),
                  f"{name} training: steps {step_text(rec)}")
            check(len(rec.calls) == n_calls and all(
                per_batch(c, len(c["args"][0])) for c in rec.calls),
                  f"{name} eval launches {[c['launches'] for c in rec.calls]}")
            check(np.isfinite(acc) and 0.0 <= acc <= 100.0
                  and saved["accuracy"] == acc and len(saved["results"]) == 64,
                  f"{name} score {acc}, pickle {saved.get('accuracy')}")
            check(len(sub) == 8 and all(set(r) == keys for r in sub)
                  and all(str(r.get("answer", r.get("prediction"))).startswith(
                      "answer") for r in sub)
                  and sorted(os.listdir(out_dir)) == want_dir,
                  f"{name} submission {sub[:2]}, output dir "
                  f"{os.listdir(out_dir)}")
            out[name] = dict(entry_out, score=float(acc), test_rows=len(sub),
                             **timings(rec, final, ran))
            del model

        # --- (c) NLVR2 in pair mode (AdamW) and in concat mode (Adamax): 1
        # epoch of 2 steps, eval on 64 statements ([128, 95] and [64, 135])
        for mode, optim in (("pair", "adamw"), ("concat", "adamax")):
            name = f"nlvr_{mode}"
            acc, rec, ran = drive(run_nlvr, ("evaluate",), run_nlvr, [
                "--feat_file", fx["feat_file"], "--examples", fx["nlvr_train"],
                "--val_examples", fx["nlvr_val"], "--pair_mode", mode,
                "--optim", optim, "--num_train_epochs", "1",
                "--per_gpu_train_batch_size", "8"])
            model = rec.model
            final = rec.calls[0]
            data = final["args"][0]
            entry_out = compare(name, model, data, final["result"][2],
                                lambda m: run_nlvr.evaluate(m, data, 64)[2])
            check(steps_ok(rec, 2), f"{name} training: steps {step_text(rec)}")
            check(len(rec.calls) == 1 and per_batch(final, len(data))
                  and np.isfinite(acc),
                  f"{name} eval launches {final['launches']}, accuracy {acc}")
            out[name] = dict(entry_out, accuracy=float(acc),
                             **timings(rec, final, ran))
            del model

        # --- (d) retrieval: every caption x image pair of 8 images (64
        # pairs, [64, 120]) after 4 steps of 16 pairs; the hard-negative
        # re-rank (8 candidates an image) after 2 steps on candidate
        # negatives; the 3-D CL mask after 2 steps (K3 none)
        ret = ["--feat_file", fx["feat_file"], "--captions", fx["captions"],
               "--per_gpu_train_batch_size", "16"]
        variants = (("retrieval", ["--train_steps", "4"]),
                    ("retrieval_rerank", ["--train_steps", "2",
                                          "--eval_caption_index_file",
                                          fx["cand"], "--hard_negative_training"]),
                    ("retrieval_cl", ["--train_steps", "2", "--att_mask_type",
                                      "CL"]))
        twin = None
        for name, extra in variants:
            metrics, rec, ran = drive(run_retrieval, ("pair_logits",),
                                      run_retrieval, ret + extra)
            model = rec.model
            final = rec.calls[0]
            data, pairs = final["args"][:2]
            entry_out = compare(
                name, model, data, final["result"],
                lambda m: run_retrieval.pair_logits(m, data, pairs, 64),
                scores=True)
            check(steps_ok(rec, int(extra[1])),
                  f"{name} training: steps {step_text(rec)}")
            check(len(rec.calls) == 1 and len(pairs) == 64
                  and per_batch(final, 64, k3=name != "retrieval_cl")
                  and all(np.isfinite(v) for v in metrics.values()),
                  f"{name} eval launches {final['launches']}, metrics "
                  f"{metrics}, {len(pairs)} pairs")
            out[name] = dict(entry_out, metrics={k: float(v) for k, v in
                                                 metrics.items()},
                             **timings(rec, final, ran))
            if name == "retrieval":
                twin = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
            del model

        # --- (e) --save_every / --resume: the retrieval run cut at step 2,
        # then resumed to 4, against its uninterrupted twin (d)
        def final_params(argv):
            with Driven(run_retrieval, (), counters, build=draw_biases) as rec:
                run_retrieval.main(argv + flags)
            return {k: v.detach().clone()
                    for k, v in rec.model.state_dict().items()}

        def largest_gap(a, b):
            return max(float((a[k].float() - b[k].float()).abs().max())
                       for k in a)

        state_dir = ["--output_dir", f"{root}/ret_state"]
        base = ret + variants[0][1]
        final_params(base + state_dir + ["--max_steps", "2", "--save_every", "2"])
        resumed = final_params(base + state_dir + ["--resume"])
        bit_equal = all(torch.equal(resumed[k], twin[k]) for k in twin)
        resume = {"bit_equal": bit_equal, "gap": largest_gap(resumed, twin)}
        if not bit_equal:
            # a nondeterministic op: hold the pair to two uninterrupted runs
            resume["twin_gap"] = largest_gap(final_params(base), twin)
        check(bit_equal or resume["gap"] <= resume["twin_gap"],
              f"retrieval --resume against its uninterrupted twin: {resume}")
        out["resume"] = resume
    phase_s = time.perf_counter() - t_phase
    print(f"phase 13 Oscar runners ({smi}) in {phase_s:.1f} s (fixture and "
          f"checkpoint {setup_s:.1f} s): "
          + "; ".join(
              f"{k}: {len(v['losses'])} steps at {v['ms_per_step']:.1f} host "
              f"ms/step (losses {v['losses'][0]:.4f} -> {v['losses'][-1]:.4f}), "
              f"eval {v['eval_ms_per_batch']:.1f} host ms/batch, gap to f32 "
              f"{v['gap']:.3e} (tol {v['tol']}; plain bf16 path "
              f"{v['plain_gap']:.3e}), faults "
              + ", ".join(f"{f} {e:.3e} ({e / v['tol']:.1f}x tol, "
                          f"{e / v['gap']:.1f}x gap)"
                          for f, e in v["fault_gaps"].items())
              + ", " + ", ".join(f"{m} {x:.2f}" for m, x in (
                  v["metrics"].items() if "metrics" in v else
                  [("score" if "score" in v else "accuracy",
                    v.get("score", v.get("accuracy")))]))
              for k, v in out.items() if k != "resume")
          + f"; resume {out['resume']}", flush=True)
    if failed:
        raise AssertionError(f"phase 13: {failed}")
    out = {f"oscar_{k}": v for k, v in out.items()}
    out["seconds"] = phase_s
    return out


# Phase 14: Oscar captioning (``tools/run_captioning``) at full width. The
# caption forward carries a [B, S, S] seq2seq mask, so each deterministic
# forward launches K4 in every layer and never K3 (whose gate takes a
# key-only bias), or K6 with the [B, 1, S, S] bias under "flash"; a decode
# runs one forward a step over the fixed canvas, ``CAPTION_STEPS`` steps.
CAPTION_STEPS = 39                # --max_seq_a_length 40: steps 1 .. 39
# phase 14 runs the captioning model at this depth (of Oscar-base's 12, at
# full width and vocab): phase 20 pushed the whole script past 480 s (496.0
# s with phase 14 at 12 layers, 70.4-82.7 s of it), and a decode step's
# host time grows with the layers it runs. Phase 14 alone on the H100
# 80GB HBM3 at 700 W (PR 22): 51.9 s at 6 layers, the 2-D mask fault
# 2.0x CAPTION_TOL (2.24x in the 12-layer calibration); at 4 layers 37.9 s
# but that fault 1.1x, at 8 76.1 s (PERF.md). Phase 22 pushed the script
# past 480 s again (523.1 s): phase 14 alone took 47.1 s at 6
# layers (the 2-D mask 2.1x, the gap 3.342e-2) and 33.7 s at 3 (1.8x, the
# gap 2.696e-2), every check passing.
CAPTION_LAYERS = 3
# phase 14's SCST steps of 5 rollouts (each ~1.3-2.4 s)
SCST_STEPS = 1
# Named faults of the teacher-forced log-probs, each on the f32 oracle: the
# 2-D key-only mask (every query sees every valid key, future caption
# tokens included), no [MASK] written at step t (the target visible), the
# logits read at t + 1, and the tied embedding table in place of the
# untied decoder that the run's model carries.
CAPTION_FAULTS = ("mask_2d", "no_mask_token", "read_t_plus_1", "tied_table")
# The bf16 per-step log-probs (nats) of the beam decode's best captions
# under "auto" against the f32 einsum path on the same weights rounded to
# bf16, as the largest |Δ| over the 312 live steps of 8 captions. Set from
# the calibration run (H100 80GB HBM3, 700 W; phase 14 alone) as phases
# 11 and 13 set theirs: the geometric mean of the largest sound gap and the
# smallest fault's, where below 3× the gap. The gap read 3.894e-2 (the
# plain bf16 path 2.360e-2), the faults: the 2-D mask 0.1960, no [MASK]
# 0.3252, read at t + 1 0.3873, the tied table 3.281; sqrt(3.894e-2 ·
# 0.1960) = 8.7e-2, 2.24× either way.
CAPTION_TOL = 8.7e-2


# The fresh head's bias, 0 in flax's init, is drawn for the phase so that
# the random model's captions use the words of the fixture's captions (the
# toy vocabulary, every other id biased down): without it every decode is
# [UNK]s, every CIDEr-D reward 0, and so every SCST advantage and gradient.
CAPTION_OTHER_BIAS = -10.0


def caption_head_bias(model) -> None:
    """``model``'s MLM bias: N(0, 1) (seed 0) on the toy vocabulary's
    words, CAPTION_OTHER_BIAS on every other id."""
    import torch

    from cpt_tpu_torch.utils.tokenization import toy_vocab

    words = sorted(i for i in toy_vocab().values() if i >= 104)
    bias = torch.full(model.mlm_head.bias.shape, CAPTION_OTHER_BIAS)
    bias[words] = torch.randn(len(words), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.mlm_head.bias.copy_(bias)


def set_config(model, **changes) -> None:
    """Every module of ``model`` that carries the BERT config gets it with
    ``changes`` for good (``config_changed`` does it for a while)."""
    for m in model.modules():
        if hasattr(m, "config"):
            m.config = dataclasses.replace(m.config, **changes)


def caption_step_logprobs(model, tokens, ctx, fault=None):
    """Teacher-forced per-step log-probs [n, La − 1] (f32) of ``tokens``
    [n, La] under ``model`` on the decode canvas (``ctx`` = segment_ids,
    attn, img_feats, base_ids): at step t [MASK] at t, the logits read at
    t, log_softmax at the token. ``fault`` one of CAPTION_FAULTS."""
    import torch

    segs, attn, feats, base = ctx
    if fault == "mask_2d":
        attn = attn.amax(dim=1)
    n, la = tokens.shape
    out = []
    with torch.no_grad():
        for t in range(1, la):
            canvas = base.long().clone()
            canvas[:, :la] = tokens
            if fault != "no_mask_token":
                canvas[:, t] = 103
            pos = torch.full((n, 1), t + (fault == "read_t_plus_1"),
                             dtype=torch.long, device=tokens.device)
            logits = model(canvas, attn, segs, img_feats=feats,
                           masked_pos=pos)[1][:, 0].float()
            logp = torch.log_softmax(logits, -1)
            out.append(torch.gather(logp, 1, tokens[:, t:t + 1].long())[:, 0])
    return torch.stack(out, 1)


def check_flash_seq2seq(rows: list, b: int) -> None:
    """K6 at a decode's shape [b, 12, 120, 64] (b 5: beams; 1: greedy) with
    the caption model's bias, ``(1 − mask)·−10000`` of seq2seq masks
    (``caption_attention_mask``: canvas 40, 30 od slots, 50 regions; od
    labels 3-30, regions 10-50 valid, one training-like caption of 12 whose
    dead rows see nothing), against its plain version in f32. Named
    faults: the bias read as a key-only bias (row 0 broadcast to every
    query), the bias transposed, and K6's own (uniform attention, the bias
    dropped, the scale dropped)."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.models.bert.captioning import caption_attention_mask
    from cpt_tpu_torch.models.bert.model import extend_attention_mask
    from cpt_tpu_torch.ops.attention import flash_mha, reference_flash_mha

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    h, s_len = 12, 120
    masks = np.stack([caption_attention_mask(40, 30, 50, a, o, r) for a, o, r in
                      ((40, 3, 50), (40, 12, 10), (40, 7, 33), (12, 5, 50),
                       (40, 30, 50))[:b]])
    bias = extend_attention_mask(torch.from_numpy(masks).to(dev), torch.bfloat16)
    q, k, v = (torch.randn(b, h, s_len, 64, generator=g, device=dev)
               for _ in range(3))
    q, k, v = (q * 2).bfloat16(), k.bfloat16(), v.bfloat16()
    qf, kf, vf, bf = q.float(), k.float(), v.float(), bias.float()
    scale = 0.125

    def plain(qq, kk, vv, bb, sc=scale):
        return lambda: reference_flash_mha(qq, kk, vv, bb, sm_scale=sc)

    faults = {"key_only": plain(qf, kf, vf, bf[:, :, :1, :]),
              "transposed": plain(qf, kf, vf, bf.transpose(-1, -2)),
              "uniform": plain(qf * 0, kf, vf, bf),
              "no_bias": plain(qf, kf, vf, None),
              "no_scale": plain(qf, kf, vf, bf, 1.0)}
    mask = (bias * scale).bfloat16()
    compare("K6", f"q=[{b},{h},{s_len},64] bias=[{b},1,{s_len},{s_len}] seq2seq",
            lambda: flash_mha(q, k, v, bias, sm_scale=scale),
            plain(q, k, v, bias), plain(qf, kf, vf, bf), rows, faults,
            work=(nbytes(q, k, v, bias) + nbytes(q),
                  4 * b * h * s_len * s_len * 64, BF16_OPS_S),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=scale),
            device="flash_attention_kernel")


def run_captioning_phase(counters, smi: str, rows: list, dev, dt, bcfg) -> dict:
    """Phase 14 (see the module docstring): ``run_captioning.main`` at the
    width of ``bcfg`` (Oscar-base on the card; the untied decoder) from one
    random Oscar-layout checkpoint (seed 0), its MLM head fresh (seed 0),
    on phase 13's fixture (8 captioned images of 50 2054-d regions).
    Gathers every reading, prints it, then raises on the first check that
    failed."""
    import shutil

    import torch

    from cpt_tpu_torch.tools import run_captioning as rc
    from cpt_tpu_torch.utils import convert as cv

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    # the kernels at the decode's shapes: K4 over 5 beams of S 120 (the
    # SCST rollouts' [5, 120] too), one greedy row and CBS's 4 states × 5
    # beams; K6 with the seq2seq bias over 5 beams and one greedy row
    if dev.type == "cuda":
        for m in (600, 120, 2400):
            check_k4(rows, m)
        for b in (5, 1):
            check_flash_seq2seq(rows, b)

    layers = min(CAPTION_LAYERS, bcfg.num_hidden_layers)
    flags = ["--device", dev.type, "--dtype",
             "bfloat16" if dt == torch.bfloat16 else "float32", "--hidden_size",
             str(bcfg.hidden_size), "--num_hidden_layers",
             str(layers), "--img_feature_dim",
             str(bcfg.img_feature_dim), "--seed", "0", "--no_tie_weights"]
    per_decode = CAPTION_STEPS * layers
    evals = ("greedy_or_sample", "beam_search", "constrained_beam_search",
             "scst_step")
    out, peaks = {}, []

    def want(k4, k6=0):
        w = {k: 0 for k in counters}
        w.update({"K4": k4, "K6": k6})
        return w

    def calls_ok(rec, name, n, launches):
        calls = [c for c in rec.calls if c["name"] == name]
        return (len(calls) == n and all(c["launches"] == launches
                                        for c in calls)), calls

    def drive(argv, build=caption_head_bias):
        """``main(argv + flags)`` driven (the calls of ``evals`` recorded),
        each SCST step's peak of allocated device memory read."""
        real_scst = rc.scst_step

        @functools.wraps(real_scst)
        def scst_step(*a, **kw):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            result = real_scst(*a, **kw)
            if dev.type == "cuda":
                peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
            return result

        rc.scst_step = scst_step
        try:
            with Driven(rc, evals, counters, build=build) as drv:
                result = rc.main(argv + flags)
        finally:
            rc.scst_step = real_scst
        for call in drv.calls:
            if call["name"] == "scst_step":
                # the rewards only: the gradients are not kept past the run
                call["result"] = (None,) + tuple(call["result"][1:])
        return result, drv

    def timings(calls):
        return float(np.mean([c["ms"] for c in calls])) if calls else None

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fx = oscar_fixture(root, bcfg.img_feature_dim)
        ckpt = f"{root}/oscar.pth"
        enc = rc.model_config(rc.build_args().parse_args(flags))
        torch.save({k: torch.from_numpy(v) for k, v in cv.random_oscar_state_dict(
            enc, seed=0).items()}, ckpt)
        data = ["--feat_file", fx["feat_file"], "--captions", fx["captions"],
                "--checkpoint", ckpt]
        # the decode-only runs caption the first 4 images
        with open(fx["captions"]) as f:
            four = dict(sorted(json.load(f).items())[:4])
        with open(f"{root}/captions4.json", "w") as f:
            json.dump(four, f)
        xe = ["--train_steps", "4", "--per_gpu_train_batch_size", "16",
              "--drop_worst_ratio", "0.2", "--drop_worst_after", "2"]
        setup_s = time.perf_counter() - t0

        # --- (a) 4 XE steps (dropout 0.1: no kernel), --eval_every 2 on 2
        # images (greedy), SCST_STEPS SCST steps of 5 rollouts (greedy baseline),
        # then beam 5 keeping 2 over the 8 images; the step-4 state saved
        d1 = f"{root}/run"
        (cider, outputs), rec = drive(data + xe + [
            "--save_every", "4",
            "--eval_every", "2", "--eval_subset", "2", "--output_dir", d1,
            "--scst_steps", str(SCST_STEPS), "--sc_train_sample_n", "5", "--num_beams",
            "5", "--num_keep_best", "2", "--output", f"{root}/beam.pk"])
        model = rec.model
        check(len(rec.steps) == 4 and all(np.isfinite(s["loss"]) and not any(
            s["launches"].values()) for s in rec.steps),
              f"caption XE steps {[(s['loss'], s['launches']) for s in rec.steps]}")
        ok, evals_ = calls_ok(rec, "greedy_or_sample", 4, want(per_decode))
        check(ok, f"caption eval decodes {[c['launches'] for c in evals_]}")
        ok, scst = calls_ok(rec, "scst_step", SCST_STEPS, want(3 * per_decode))
        check(ok and all(np.isfinite(c["result"][1]) for c in scst),
              f"caption SCST steps {[(c['launches'], c['result'][1:]) for c in scst]}")
        ok, beams = calls_ok(rec, "beam_search", 8, want(per_decode))
        check(ok, f"caption beam decodes {[c['launches'] for c in beams]}")
        with open(f"{d1}/eval_logs.json") as f:
            logs = json.load(f)
        with open(f"{root}/beam.pk", "rb") as f:
            saved = pickle.load(f)
        check([e["step"] for e in logs] == [2, 4] and np.isfinite(cider)
              and len(outputs) == 8 and all(len(v) == 2 for v in outputs.values())
              and all(np.isfinite(m) for m in saved["metrics"].values()),
              f"caption beam run: logs {logs}, CIDEr {cider}, metrics "
              f"{saved['metrics']}, outputs {list(outputs.values())[:1]}")
        out["caption_xe"] = {"launches": rec.train_launches,
                             "losses": [s["loss"] for s in rec.steps],
                             "step_ms": [s["ms"] for s in rec.steps],
                             "ms_per_step": rec.ms_per_step()}
        out["caption_eval"] = {"launches": {k: sum(c["launches"][k] for c in evals_)
                                            for k in counters},
                               "ms_per_decode": timings(evals_)}
        out["caption_scst"] = {"launches": {k: sum(c["launches"][k] for c in scst)
                                            for k in counters},
                               "ms_per_step": timings(scst),
                               "rewards": [c["result"][1:] for c in scst],
                               "peak_gib": max(peaks) if peaks else None}
        out["caption_beam"] = {"launches": {k: sum(c["launches"][k] for c in beams)
                                            for k in counters},
                               "ms_per_decode": timings(beams),
                               "metrics": saved["metrics"]}

        # bf16 teacher-forced log-probs of the beam decode's best captions
        # against the f32 einsum oracle on the same weights, and the faults
        toks = torch.stack([c["result"][0][0, 0] for c in beams])
        ctx = [torch.cat(x) for x in zip(*[
            (c["args"][1], c["args"][2], c["args"][3], c["kw"]["base_ids"])
            for c in beams])]
        live = toks[:, 1:] != 0
        got = caption_step_logprobs(model, toks, ctx)
        oracle = ft_oracle(model)
        want_lp = caption_step_logprobs(oracle, toks, ctx)
        with config_changed(model, attention_impl="einsum", ffn_impl="dense"):
            plain = caption_step_logprobs(model, toks, ctx)

        def gap(x):
            return float((x - want_lp).abs()[live].max())

        faults = {}
        for fault in CAPTION_FAULTS:
            if fault == "tied_table":
                with torch.no_grad():
                    kept = oracle.mlm_head.decoder.clone()
                    oracle.mlm_head.decoder.copy_(
                        oracle.bert.embeddings.word_embeddings)
                faults[fault] = gap(caption_step_logprobs(oracle, toks, ctx))
                with torch.no_grad():
                    oracle.mlm_head.decoder.copy_(kept)
            else:
                faults[fault] = gap(caption_step_logprobs(oracle, toks, ctx, fault))
        lp = {"gap": gap(got), "plain_gap": gap(plain),
              "mean_gap": float((got - want_lp).abs()[live].mean()),
              "fault_gaps": faults, "tol": CAPTION_TOL,
              "live_steps": int(live.sum()),
              "mean_logprob": float(want_lp[live].mean())}
        check(lp["gap"] <= CAPTION_TOL and torch.isfinite(got).all(),
              f"caption log-probs: gap to f32 {lp['gap']} (tol {CAPTION_TOL})")
        check(all(e > CAPTION_TOL for e in faults.values()),
              f"caption log-probs: a fault passes {faults} (tol {CAPTION_TOL})")
        out["caption_beam"]["logprobs"] = lp
        del oracle

        # device time of one beam decode by kernel family
        if dev.type == "cuda":
            c0 = beams[0]
            out["caption_beam"]["profile"] = profiled(
                lambda: rc.beam_search(model, *c0["args"], **c0["kw"]),
                "one beam decode (5 beams, 39 steps)")

        # --- (b) --resume: the XE run cut at step 2 (a 1-step decode), then
        # resumed to 4 with a greedy decode; its step-4 train state against
        # run (a)'s, which took the same steps
        d2 = f"{root}/cut"
        drive(data + xe + ["--output_dir", d2, "--max_steps", "2",
                           "--save_every", "2", "--num_beams", "1",
                           "--max_gen_length", "2"])
        (_, greedy_out), rec_g = drive(data + xe + [
            "--output_dir", d2, "--save_every", "2", "--resume",
            "--num_beams", "1"])
        ok, greedy = calls_ok(rec_g, "greedy_or_sample", 8, want(per_decode))
        check(ok and len(rec_g.steps) == 2 and len(greedy_out) == 8,
              f"caption greedy decodes {[c['launches'] for c in greedy]}, "
              f"resumed steps {len(rec_g.steps)}")

        def state(d):
            return torch.load(f"{d}/state/step4/state.pt", weights_only=True)

        def tensors(x):
            if isinstance(x, torch.Tensor):
                return [x]
            items = (x[k] for k in sorted(x)) if isinstance(x, dict) else (
                x if isinstance(x, (list, tuple)) else ())
            return [t for v in items for t in tensors(v)]

        a, b = tensors(state(d1)), tensors(state(d2))
        resume = {"bit_equal": len(a) == len(b) > 0 and all(
            torch.equal(x, y) for x, y in zip(a, b))}
        resume["gap"] = max(float((x.float() - y.float()).abs().max())
                            for x, y in zip(a, b))
        if not resume["bit_equal"]:
            # a nondeterministic op: hold the pair to two uninterrupted runs
            d3 = f"{root}/twin"
            drive(data + xe + ["--output_dir", d3, "--save_every", "4",
                               "--num_beams", "1", "--max_gen_length", "2"])
            resume["twin_gap"] = max(float((x.float() - y.float()).abs().max())
                                     for x, y in zip(a, tensors(state(d3))))
        check(resume["bit_equal"] or resume["gap"] <= resume["twin_gap"],
              f"caption --resume against its uninterrupted twin: {resume}")
        out["caption_greedy"] = {"launches": {k: sum(c["launches"][k] for c in greedy)
                                              for k in counters},
                                 "ms_per_decode": timings(greedy),
                                 "resume": resume}
        shutil.rmtree(d2, ignore_errors=True)

        # --- (c) on run (a)'s step-4 state (--resume, no step left), 4
        # images and the reference's 20-token generation (--max_gen_length
        # 20: 19 steps over the full canvas): sampling (top-k 20, 2 draws
        # an image) under "flash" (K6 and K4 one a layer a step, K3 none), and CBS
        # over 2 od labels
        resumed = ["--feat_file", fx["feat_file"], "--captions",
                   f"{root}/captions4.json", "--checkpoint", ckpt] + xe + [
            "--output_dir", d1, "--resume", "--max_gen_length", "20"]
        per_short = 19 * layers
        (_, samples), rec_s = drive(resumed + [
            "--do_sample", "--top_k", "20", "--num_return_sequences", "2"],
            build=lambda m: (caption_head_bias(m),
                             set_config(m, attention_impl="flash")))
        ok, sampled = calls_ok(rec_s, "greedy_or_sample", 8,
                               want(per_short, per_short))
        check(ok and len(samples) == 4
              and all(len(v) == 2 for v in samples.values()),
              f"caption flash sampling decodes {[c['launches'] for c in sampled]}")
        out["caption_flash"] = {"launches": {k: sum(c["launches"][k] for c in sampled)
                                             for k in counters},
                                "ms_per_decode": timings(sampled)}
        (_, cbs_out), rec_c = drive(resumed + ["--use_cbs", "--num_constraints",
                                               "2", "--num_beams", "5"])
        ok, cbs = calls_ok(rec_c, "constrained_beam_search", 4, want(per_short))
        # the constraints are each image's first two od-label words, as the
        # tool's toy tokenizer splits them ("[UNK]" for a word it lacks):
        # every caption holds one (at least 1 of 2 to satisfy)
        src = rc.load_sources(rc.build_args().parse_args(data))
        tokenizer = rc.build_tokenizer(rc.build_args().parse_args(data))

        def holds(words, pieces):
            return any(pieces[i:i + len(words)] == words
                       for i in range(len(pieces)))

        met = sum(any(holds(tokenizer.tokenize(w), text.split()) for w in list(
            dict.fromkeys(src.get_feats(k)[1].split()))[:2])
            for k, text in cbs_out.items())
        check(ok and len(cbs_out) == 4 and met == 4,
              f"caption CBS decodes {[c['launches'] for c in cbs]}, "
              f"{met} of 4 captions hold a constraint")
        out["caption_cbs"] = {"launches": {k: sum(c["launches"][k] for c in cbs)
                                           for k in counters},
                              "ms_per_decode": timings(cbs),
                              "captions_with_a_constraint": met}
        del model
    phase_s = time.perf_counter() - t_phase
    lp = out["caption_beam"]["logprobs"]
    print(f"phase 14 captioning ({smi}) in {phase_s:.1f} s (fixture and "
          f"checkpoint {setup_s:.1f} s): XE {out['caption_xe']['ms_per_step']:.1f} "
          f"host ms/step (each {out['caption_xe']['step_ms']}, saves and "
          f"evals included; losses {out['caption_xe']['losses']}); SCST "
          f"{out['caption_scst']['ms_per_step']:.1f} host ms/step, peak "
          f"{out['caption_scst']['peak_gib']} GiB, rewards "
          f"{out['caption_scst']['rewards']}; host ms per decode: "
          + ", ".join(f"{k[8:]} {out[k]['ms_per_decode']:.1f}" for k in (
              "caption_eval", "caption_beam", "caption_greedy", "caption_flash",
              "caption_cbs"))
          + " (the last two 19 steps, the others 39)"
          + f"; beam metrics {out['caption_beam']['metrics']}; bf16 log-probs: "
          f"gap to f32 {lp['gap']:.4e} (mean {lp['mean_gap']:.4e}, tol "
          f"{lp['tol']}; plain bf16 path {lp['plain_gap']:.4e}; mean log-prob "
          f"{lp['mean_logprob']:.3f} over {lp['live_steps']} steps), faults "
          + ", ".join(f"{f} {e:.4e} ({e / lp['tol']:.1f}x tol, "
                      f"{e / max(lp['gap'], 1e-30):.1f}x gap)"
                      for f, e in lp["fault_gaps"].items())
          + f"; resume {out['caption_greedy']['resume']}; CBS captions with a "
          f"constraint {out['caption_cbs']['captions_with_a_constraint']}/4",
          flush=True)
    if failed:
        raise AssertionError(f"phase 14: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 15: Oscar+ pretraining, run_vqa on VQ-VAE codes and explore at full
# width. A pretraining step at the default dropout 0.1 launches no kernel
# (dropout keeps K3 and K4 off); under --drop_out 0 each forward launches
# K4 12 (the attention probabilities' dropout 0.1 keeps K3 off), whose
# backward is the plain VJP.
PRETRAIN_STEPS = 4
# Named faults of one pretraining batch's losses, each on the f32 oracle:
# the MLM labels read one position late, the contrastive labels 0 and 1
# swapped, the image positions masked out of attention, the pooler reading
# the last position in place of [CLS].
PRETRAIN_FAULTS = ("mlm_labels_late", "contrast_swapped", "image_masked",
                   "pooler_last_token")
# The fresh heads' biases are drawn from N(0, PRETRAIN_BIAS_STD²) (seed 0),
# so that the losses depend on which label each position holds: the random
# encoder's logits are otherwise all but flat.
PRETRAIN_BIAS_STD = 1.0
# bf16 on the card under "auto" (eval mode: K3 and K4 12 a forward) against
# the f32 einsum path on the same weights, the larger |Δ| of the MLM and
# contrastive losses in nats. Set from the calibration run (H100 80GB HBM3,
# 700 W; PERF.md §6): the bf16 gap 6.064e-3, the smallest fault's 9.931e-2
# (contrast_swapped); their geometric mean, 4× from either.
PRETRAIN_TOL = 2.4e-2
EXPLORE_SLOTS = (2, 2)


def write_vocab(path: str) -> str:
    """A BERT-layout vocabulary file for the full-width tools: [PAD], the
    [unusedN] rows, the specials at 100-103, then the toy vocabulary's
    words (as ``toy_vocab`` numbers them, less its gap)."""
    from cpt_tpu_torch.utils.tokenization import toy_vocab

    words = [w for w, i in sorted(toy_vocab(OSCAR_WORDS).items(),
                                  key=lambda kv: kv[1]) if i > 103]
    lines = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def refcoco_fixture(root: str, dim: int, n_queries: int = 8, n_copies: int = 4,
                    n_objects: int = 10, seed: int = 0) -> dict:
    """A RefCOCO CPT predictions TSV with its annotations and od labels
    (the JAX package's ``generate_refcoco_fixture`` layout): query q's
    painted copy ``q % n_copies`` holds the gt box and a marked first
    feature, each other copy a distant box."""
    from cpt_tpu_torch.utils.tsv import encode_feature, tsv_writer

    rng = np.random.RandomState(seed)
    rows, anns = [], []
    for q in range(n_queries):
        gt = [10.0 * q, 10.0, 10.0 * q + 19.0, 29.0]
        objs, colors, rects = [], [], []
        for c in range(n_copies):
            feats = rng.randn(n_objects, dim).astype(np.float32) * 0.1
            if c == q % n_copies:
                feats[:, 0] = 3.0
            objs.append([{"rect": [0, 0, 5, 5], "class": "dog" if b else "cat",
                          "conf": 0.9, "feature": encode_feature(feats[b])}
                         for b in range(n_objects)])
            colors.append(["red"])
            rects.append([gt if c == q % n_copies
                          else [200.0 + 30 * c, 200.0, 229.0 + 30 * c, 229.0]])
        rows.append([f"val{q}", json.dumps(
            {"objects": [objs, f"the red dog {q}", colors, rects]})])
        anns.append({"id": f"val{q}", "bbox": [gt[0], gt[1], gt[2] - gt[0] + 1,
                                               gt[3] - gt[1] + 1]})
    p = {"data_file": f"{root}/refcoco.tsv", "ann_file": f"{root}/refcoco_ann.json",
         "det_file": f"{root}/refcoco_det.json"}
    tsv_writer(rows, p["data_file"])
    with open(p["ann_file"], "w") as f:
        json.dump(anns, f)
    with open(p["det_file"], "w") as f:
        json.dump({f"val{q}": ["cat"] + ["dog"] * (n_objects - 1)
                   for q in range(n_queries)}, f)
    return p


def code_vqa_fixture(root: str, n_img: int = 16, n_codes: int = 50,
                     code_voc: int = 512, code_dim: int = 512,
                     seed: int = 5) -> str:
    """run_vqa's qla layout with VQ-VAE codes: ``n_img`` images of
    ``n_codes`` code ids, 16 questions over 16 labels, and under
    ``vqvae/`` a [code_dim, code_voc] top-level codebook with those codes
    (``train.pt`` for the codebook, ``train2014.pt`` for the split)."""
    import torch

    rng = np.random.RandomState(seed)
    feats = {f"im{i}": torch.from_numpy(rng.randint(0, code_voc, n_codes))
             for i in range(n_img)}
    torch.save(feats, f"{root}/train2014_img_frcnn_feats.pt")
    qla = [{"q": f"what is the {OSCAR_WORDS[q % 12]} on the left",
            "o": "man;dog", "an": [q % 16], "s": [1.0], "img_id": f"im{q}",
            "q_id": q} for q in range(n_img)]
    with open(f"{root}/train2014_qla.json", "w") as f:
        json.dump(qla, f)
    os.makedirs(f"{root}/vqvae")
    vq = {"embeddings_t": rng.randn(code_dim, code_voc).astype(np.float32),
          "feats_top": feats}
    for name in ("train", "train2014"):
        torch.save(vq, f"{root}/vqvae/{name}.pt")
    return root


def pretrain_losses(model, batch, fault=None) -> tuple:
    """(MLM, contrastive) losses of ``model`` in eval mode on one pretraining
    batch, with ``fault`` (PRETRAIN_FAULTS) applied."""
    import torch

    from cpt_tpu_torch.tools import run_oscarplus_pretrain as pre

    ids, segs, attn, feats, mlm, contrast = batch
    if fault == "mlm_labels_late":
        mlm = torch.cat([mlm[:, :1] * 0 - 1, mlm[:, :-1]], dim=1)
    elif fault == "contrast_swapped":
        contrast = torch.where(contrast == 0, 1,
                               torch.where(contrast == 1, 0, contrast))
    elif fault == "image_masked":
        attn = attn.clone()
        attn[:, ids.shape[1]:] = 0
    pooler = model.bert.pooler
    if fault == "pooler_last_token":
        pooler.forward = lambda seq: torch.tanh(pooler.dense(seq[:, -1]))
    model.eval()
    try:
        with torch.no_grad():
            m, n = pre.batch_loss(model, (ids, segs, attn, feats, mlm, contrast),
                                  False, None)
    finally:
        pooler.__dict__.pop("forward", None)
    return float(m), float(n)


def pretrain_head_bias(model) -> None:
    """The fresh MLM and NSP heads' biases drawn from N(0,
    PRETRAIN_BIAS_STD²), seed 0."""
    import torch

    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for bias in (model.mlm_head.bias, model.nsp_head.dense.bias):
            bias.copy_(torch.randn(bias.shape, generator=g) * PRETRAIN_BIAS_STD)


def run_pretraining_phase(counters, smi: str, rows: list, dev, dt, bcfg) -> dict:
    """Phase 15 (see the module docstring): ``run_oscarplus_pretrain.main``,
    ``run_vqa.main --img_feature_type dis_code`` and ``explore.main`` at the
    width of ``bcfg`` (Oscar-base on the card) from random Oscar-layout
    weights (seed 0). Gathers every reading, prints it, then raises on the
    first check that failed."""
    import random

    import torch

    from cpt_tpu_torch.tools import explore
    from cpt_tpu_torch.tools import run_oscarplus_pretrain as pre
    from cpt_tpu_torch.tools import run_vqa
    from cpt_tpu_torch.utils import convert as cv

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def want(**n):
        w = {k: 0 for k in counters}
        w.update(n)
        return w

    t_phase = time.perf_counter()
    dtype = "bfloat16" if dt == torch.bfloat16 else "float32"
    width = ["--hidden_size", str(bcfg.hidden_size), "--num_hidden_layers",
             str(bcfg.num_hidden_layers)]
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fx = oscar_fixture(root, bcfg.img_feature_dim)
        caps = f"{root}/pretrain_captions.json"
        with open(fx["captions"]) as f:
            first = json.load(f)
        with open(caps, "w") as f:
            json.dump({f"im{i}": first.get(f"im{i}", [f"a {OSCAR_WORDS[i % 12]} "
                                                     f"near the tree"])[0]
                       for i in range(16)}, f)
        flags = ["--device", dev.type, "--dtype", dtype, *width,
                 "--img_feature_dim", str(bcfg.img_feature_dim), "--seed", "0",
                 "--feat_file", fx["feat_file"], "--captions", caps,
                 "--per_gpu_train_batch_size", "16", "--max_seq_length", "35",
                 "--max_img_seq_length", "50", "--learning_rate", "1e-4"]
        ckpt = f"{root}/oscar.pth"
        args0 = pre.build_args().parse_args(flags)
        enc = pre.model_config(args0)
        torch.save({k: torch.from_numpy(v) for k, v in cv.random_oscar_state_dict(
            enc, seed=0).items()}, ckpt)
        flags += ["--checkpoint", ckpt]
        setup_s = time.perf_counter() - t0

        def drive(argv):
            with Driven(pre, (), counters, build=pretrain_head_bias) as rec:
                losses = pre.main(argv + flags)
            return losses, rec

        # --- (a) 4 steps at dropout 0.1 (no kernel)
        steps = ["--train_steps", str(PRETRAIN_STEPS)]
        losses, rec = drive(steps)
        model = rec.model
        check(len(rec.steps) == PRETRAIN_STEPS and all(
            np.isfinite(s["loss"]) and s["launches"] == want()
            for s in rec.steps),
              f"pretraining steps {[(s['loss'], s['launches']) for s in rec.steps]}")
        out["pretrain"] = {"launches": rec.total(), "losses": losses,
                           "step_ms": [s["ms"] for s in rec.steps],
                           "ms_per_step": rec.ms_per_step()}
        twin = {k: v.detach().clone() for k, v in model.state_dict().items()}

        # one batch's losses in bf16 (eval: K3 and K4 12 a forward) against
        # the f32 einsum oracle on the same weights, and the faults
        args = pre.build_args().parse_args(steps + flags)
        data, _ = pre.load_corpora(args, pre.build_tokenizer(args), enc)
        batch = pre.pretrain_batch(data, list(range(16)), random.Random(0),
                                   args, dev)
        zero_counts(counters)
        got = pretrain_losses(model, batch)
        ran = {k: fn.launches for k, fn in counters.items()}
        oracle = ft_oracle(model)
        ref = pretrain_losses(oracle, batch)
        with config_changed(model, attention_impl="einsum", ffn_impl="dense"):
            plain = pretrain_losses(model, batch)

        def gap(x):
            return max(abs(a - b) for a, b in zip(x, ref))

        faults = {f: gap(pretrain_losses(oracle, batch, f))
                  for f in PRETRAIN_FAULTS}
        loss_check = {"gap": gap(got), "plain_gap": gap(plain), "losses": got,
                      "f32": ref, "fault_gaps": faults, "tol": PRETRAIN_TOL,
                      "launches": ran}
        check(loss_check["gap"] <= PRETRAIN_TOL,
              f"pretraining losses: gap to f32 {loss_check['gap']} (tol "
              f"{PRETRAIN_TOL})")
        check(ran == want(K3=bcfg.num_hidden_layers, K4=bcfg.num_hidden_layers),
              f"pretraining eval forward launches {ran}")
        check(all(e > PRETRAIN_TOL for e in faults.values()),
              f"pretraining losses: a fault passes {faults} (tol {PRETRAIN_TOL})")
        out["pretrain"]["loss_check"] = loss_check
        del model, oracle

        # --- (b) the run cut at step 2 and --resume'd to 4, against (a)
        def final(argv):
            rec_ = drive(argv)[1]
            return {k: v.detach().clone() for k, v in rec_.model.state_dict().items()}

        final(steps + ["--output", f"{root}/b", "--max_steps", "2",
                       "--save_every", "2"])
        resumed = final(steps + ["--output", f"{root}/b", "--resume"])
        resume = {"bit_equal": all(torch.equal(resumed[k], twin[k]) for k in twin),
                  "gap": max(float((resumed[k].float() - twin[k].float()).abs().max())
                             for k in twin)}
        if not resume["bit_equal"]:
            # a nondeterministic op: hold the pair to two uninterrupted runs
            again = final(steps)
            resume["twin_gap"] = max(float((again[k].float() - twin[k].float())
                                           .abs().max()) for k in twin)
        check(resume["bit_equal"] or resume["gap"] <= resume["twin_gap"],
              f"pretraining --resume against its uninterrupted twin: {resume}")
        out["pretrain"]["resume"] = resume

        # --- (c) --drop_out 0: each step's forward launches K4 12
        losses0, rec0 = drive(["--train_steps", "2", "--drop_out", "0",
                               "--texta_false_prob", "0.25"])
        check(len(rec0.steps) == 2 and all(
            np.isfinite(s["loss"]) and s["launches"] == want(
                K4=bcfg.num_hidden_layers) for s in rec0.steps),
              f"pretraining --drop_out 0 steps "
              f"{[(s['loss'], s['launches']) for s in rec0.steps]}")
        out["pretrain_k4"] = {"launches": rec0.total(), "losses": losses0,
                              "ms_per_step": rec0.ms_per_step()}
        del rec0

        # --- (d) run_vqa on VQ-VAE codes: the code table from the codebook
        # (the checkpoint has none), 1 epoch of 2 steps, eval of 16
        # questions (one batch: K3 and K4 12)
        os.makedirs(f"{root}/codes")
        qla = code_vqa_fixture(f"{root}/codes")
        vqa_flags = ["--device", dev.type, "--dtype", dtype, *width, "--seed", "0",
                     "--qla_data_dir", qla, "--img_feature_type", "dis_code",
                     "--num_labels", "16", "--num_train_epochs", "1",
                     "--per_gpu_train_batch_size", "8", "--max_img_seq_length",
                     "50", "--output", f"{root}/codes.pk"]
        vargs = run_vqa.build_args().parse_args(vqa_flags)
        run_vqa.load_codebook(vargs)
        venc = run_vqa.model_config(vargs, num_labels=16)
        vsd = cv.random_oscar_state_dict(venc, seed=0)
        del vsd["bert.code_embeddings.weight"]
        torch.save({k: torch.from_numpy(v) for k, v in vsd.items()},
                   f"{root}/codes.pth")
        tables = []

        def built(m):
            draw_biases(m)
            tables.append(m.bert.code_embeddings.detach().cpu().numpy().copy())

        with Driven(run_vqa, ("evaluate",), counters, build=built) as rec:
            acc = run_vqa.main(vqa_flags + ["--checkpoint", f"{root}/codes.pth"])
        vmodel = rec.model
        # the code table starts from the codebook (the checkpoint has none)
        table_ok = np.array_equal(tables[0], torch.load(
            f"{qla}/vqvae/train.pt", weights_only=False)["embeddings_t"].T)
        final_call = rec.calls[-1]
        vdata = final_call["args"][0]
        got_logits = final_call["result"][2]
        want_logits = run_vqa.evaluate(ft_oracle(vmodel), vdata, 64)[2]
        vgap = float(np.abs(got_logits - want_logits).max()
                     / np.abs(want_logits).max())
        check(len(rec.steps) == 2 and all(np.isfinite(s["loss"])
                                          and s["launches"] == want()
                                          for s in rec.steps)
              and len(rec.calls) == 1 and np.isfinite(acc) and table_ok,
              f"dis_code run_vqa: steps "
              f"{[(s['loss'], s['launches']) for s in rec.steps]}, "
              f"{len(rec.calls)} evals, score {acc}, code table from the "
              f"codebook {table_ok}")
        check(final_call["launches"] == want(K3=bcfg.num_hidden_layers,
                                             K4=bcfg.num_hidden_layers),
              f"dis_code run_vqa eval launches {final_call['launches']}")
        check(vgap <= OSCAR_TOL["vqa"],
              f"dis_code run_vqa: logits gap to f32 {vgap} (tol {OSCAR_TOL['vqa']})")
        out["dis_code_vqa"] = {"launches": rec.total(), "score": float(acc),
                               "gap": vgap, "ms_per_step": rec.ms_per_step(),
                               "code_table": list(vmodel.bert.code_embeddings.shape)}
        del vmodel, rec

        # --- (e) explore: templates 1-2 (one eval batch each), then the
        # soft prompt, 3 deterministic steps (K3 and K4 12 a step)
        rfx = refcoco_fixture(root, bcfg.img_feature_dim)
        ex_flags = ["--data_file", rfx["data_file"], "--ann_file",
                    rfx["ann_file"], "--det_file", rfx["det_file"], "--vocab",
                    write_vocab(f"{root}/vocab.txt"), "--device", dev.type,
                    "--dtype", dtype, "--train_batch_size", "8"]
        calls, steps_log = [], []

        def recorded(fn, log):
            def run(*a, **kw):
                zero_counts(counters)
                t = time.perf_counter()
                result = fn(*a, **kw)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                log.append({"launches": {k: f.launches for k, f in counters.items()},
                            "ms": (time.perf_counter() - t) * 1e3,
                            "result": result})
                return result
            return run

        real_eval = explore.refcoco_evaluate
        real_step = explore.train_lib.make_mlm_train_step
        explore.refcoco_evaluate = recorded(real_eval, calls)
        explore.train_lib.make_mlm_train_step = (
            lambda *a, **kw: recorded(real_step(*a, **kw), steps_log))
        models = []
        real_build, real_base = explore.build_model, explore.OSCAR_BASE
        explore.build_model = lambda *a: models.append(real_build(*a)) or models[-1]
        # the tool builds Oscar-base; the phase's width stands in for it
        explore.OSCAR_BASE = bcfg
        try:
            tmpl = explore.main(ex_flags + ["--mode", "templates", "--templates",
                                            "1,2"])
            n_tmpl = len(calls)
            soft = explore.main(ex_flags + ["--mode", "soft", "--soft_steps", "3",
                                            "--soft_slots", "%d,%d" % EXPLORE_SLOTS])
        finally:
            explore.refcoco_evaluate = real_eval
            explore.train_lib.make_mlm_train_step = real_step
            explore.build_model, explore.OSCAR_BASE = real_build, real_base
        per_batch = want(K3=bcfg.num_hidden_layers, K4=bcfg.num_hidden_layers)
        table = models[-1][0].bert.embeddings.word_embeddings.detach()
        start = cv.random_oscar_state_dict(bcfg, seed=0)[
            "bert.embeddings.word_embeddings.weight"]
        moved = float((table[1:5].cpu() - torch.from_numpy(start[1:5])).abs().max())
        kept = bool(torch.equal(table[5:].cpu(), torch.from_numpy(start[5:])))
        check(n_tmpl == 2 and len(calls) == 4
              and all(np.isfinite(v) for v in tmpl.values())
              and len(steps_log) == 3
              and all(np.isfinite(float(s["result"][1])) for s in steps_log)
              and moved > 0 and kept and len(soft["soft_readout"]) == 4,
              f"explore: {len(calls)} evals, results {tmpl}, {len(steps_log)} "
              f"soft steps, slot rows moved {moved}, other rows kept {kept}")
        check(all(c["launches"] == per_batch for c in calls + steps_log),
              f"explore launches: evals {[c['launches'] for c in calls]}, soft "
              f"steps {[s['launches'] for s in steps_log]}")
        out["explore_templates"] = {
            "launches": {k: sum(c["launches"][k] for c in calls[:n_tmpl])
                         for k in counters},
            "results": tmpl, "ms_per_eval": float(np.mean([c["ms"] for c in calls]))}
        out["explore_soft"] = {
            "launches": {k: sum(c["launches"][k] for c in calls[n_tmpl:] + steps_log)
                         for k in counters},
            "before": soft["soft_before"], "after": soft["soft_after"],
            "readout": [[t for t, _ in r[:5]] for r in soft["soft_readout"]],
            "ms_per_step": float(np.mean([s["ms"] for s in steps_log[1:]]))}
        del models
    phase_s = time.perf_counter() - t_phase
    lc = out["pretrain"]["loss_check"]
    print(f"phase 15 pretraining, dis_code, explore ({smi}) in {phase_s:.1f} s "
          f"(fixture and checkpoint {setup_s:.1f} s): pretraining "
          f"{out['pretrain']['ms_per_step']:.1f} host ms/step (each "
          f"{[round(x, 1) for x in out['pretrain']['step_ms']]}; losses "
          f"{out['pretrain']['losses']}), --drop_out 0 "
          f"{out['pretrain_k4']['ms_per_step']:.1f} host ms/step; bf16 losses "
          f"{lc['losses']} against f32 {lc['f32']}: gap {lc['gap']:.4e} (tol "
          f"{lc['tol']}; plain bf16 path {lc['plain_gap']:.4e}), faults "
          + ", ".join(f"{f} {e:.4e} ({e / lc['tol']:.1f}x tol)"
                      for f, e in lc["fault_gaps"].items())
          + f"; resume {out['pretrain']['resume']}; dis_code run_vqa score "
          f"{out['dis_code_vqa']['score']:.2f}, logits gap "
          f"{out['dis_code_vqa']['gap']:.3e}, "
          f"{out['dis_code_vqa']['ms_per_step']:.1f} host ms/step; explore "
          f"{out['explore_templates']['results']} "
          f"({out['explore_templates']['ms_per_eval']:.1f} "
          f"host ms/eval), soft {out['explore_soft']['before']} -> "
          f"{out['explore_soft']['after']} ({out['explore_soft']['ms_per_step']:.1f} "
          f"host ms/step), readout {out['explore_soft']['readout']}", flush=True)
    if failed:
        raise AssertionError(f"phase 15: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 16: detector training (``tools/train_detector``) at full X152 on the
# 1024×1024 canvas in bf16. A step's forward launches K1 53 times (the 47
# backbone blocks and 3 in each stage-5 head), K2 twice (the box and the
# attribute heads pool the 384 sampled RoIs) and K5 once (the RPN's 12,000
# → 2,000); the backward is the plain VJP (cuDNN's grouped conv, the
# separable pooling's adjoint) and launches none.
DET_STEPS = 5
DET_STEP_LAUNCHES = {"K1": 53, "K2": 2, "K5": 1}
# K1's backward at a layer3 block (stride 1) and layer2's first (stride 2)
K1_GRAD_SHAPES = [(1, 64, 64, 1024, 1), (1, 256, 256, 512, 2)]
BWD_GRAD_TOL = 2e-2     # K1's / K2's gradients in bf16 against f32, of scale
# One step on fixed proposals, bf16 against the f32 plain path: the largest
# |Δ| of the five losses in nats, and each compared leaf's gradient as its
# largest |Δ| over its largest |g|. From the calibration run (H100 80GB
# HBM3, 700 W; PERF.md §6): losses 8.315e-3 from f32, so 3× that;
# gradients 5.170e-2 at most (layer2's stride-2 conv2: bf16 and f32 put the
# ReLUs' zeros apart), the faults 1.009 and 1.084, so 2.9× the gap and
# 6.7× under the smaller fault.
DET_LOSS_TOL = 2.5e-2
DET_GRAD_TOL = 1.5e-1
DET_GRAD_LEAVES = ("box_predictor.cls_score.weight",
                   "attr_predictor.attr_score.weight",
                   "box_extractor.head.layer4.block_0.conv2.weight",
                   "attr_extractor.head.layer4.block_2.conv1.weight",
                   "backbone.layer3.block_35.conv2.weight",
                   "backbone.layer2.block_0.conv2.weight",
                   "rpn.cls_logits_weight")
# Named faults of the step's gradients: K1's dx cut (what a wrapper writing
# into a fresh tensor gives: no grad_fn) and K2's dfeats cut
DET_FAULTS = ("k1_dx_cut", "k2_dfeats_cut")
# The random VinVL weights' residual branches add up block by block:
# layer3's 36 blocks reach a std of ~5.6e6 (f32, a 256×256 canvas on the
# CPU), the first training loss read 9e8 and the next NaN (first card run).
# Phase 16 trains from the seed-0 weights with each block's last frozen BN
# (bn3, and the downsample's) scaled by DET_BRANCH_SCALE, which holds
# layer3's output std near 1.4, and the RPN's box-delta weights by
# DET_RPN_DELTA_SCALE: the random head's deltas (std ~6) decode some of the
# top proposals to a width below their coordinates' rounding, and a
# zero-width proposal makes its box-regression target's gradient NaN
# (0 · ∞; ROADMAP, "Defects of the reference, mirrored").
DET_BRANCH_SCALE = 0.3
DET_RPN_DELTA_SCALE = 0.1


def trainable_weights(sd: dict) -> dict:
    """A VinVL-layout state dict with every bottleneck's bn3 and downsample
    BN weight scaled by DET_BRANCH_SCALE and the RPN's box-delta weights by
    DET_RPN_DELTA_SCALE."""
    sd = dict(sd)
    for k in sd:
        if k.endswith(("bn3.weight", "downsample.1.weight")):
            sd[k] = sd[k] * np.float32(DET_BRANCH_SCALE)
        elif k.startswith("rpn.head.bbox_pred."):
            sd[k] = sd[k] * np.float32(DET_RPN_DELTA_SCALE)
    return sd


@contextlib.contextmanager
def plain_ops():
    """K1, K2 and K5 take their plain versions on the card meanwhile (the
    f32 oracle of a detector step)."""
    from cpt_tpu_torch.ops import grouped_conv, nms_pallas, roi_align_pallas

    mods = (grouped_conv, roi_align_pallas, nms_pallas)
    real = [m.uses_kernel for m in mods]
    for m in mods:
        m.uses_kernel = lambda t: False
    try:
        yield
    finally:
        for m, fn in zip(mods, real):
            m.uses_kernel = fn


@contextlib.contextmanager
def det_fault(fault: str):
    """K1's dx or K2's dfeats zeroed in their plain-VJP backward."""
    from cpt_tpu_torch.ops import grouped_conv, roi_align_pallas

    mod = grouped_conv if fault == "k1_dx_cut" else roi_align_pallas
    real = mod.plain_vjp

    def cut(*a, **kw):
        grads = real(*a, **kw)
        return (None if grads[0] is None else grads[0] * 0,) + tuple(grads[1:])

    mod.plain_vjp = cut
    try:
        yield
    finally:
        mod.plain_vjp = real


def check_conv_backward(shapes, g) -> list:
    """K1 under autograd at ``shapes`` ((n, h, w, c, stride), 32 groups): dx
    and dw in bf16 (the kernel forward, the plain VJP backward) against the
    f32 plain VJP on the ReLU mask that backward recomputes, within
    BWD_GRAD_TOL of scale, with the cut gradient (dx = 0) and dw of the
    neighbouring group missing it; the backward's time beside its bound."""
    import torch

    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3,
                                                reference_grouped_conv3x3)

    out = []
    for n, h, w, c, stride in shapes:
        x, wt, s, b = k1_inputs(n, h, w, c, g)
        x.requires_grad_(True)
        wt.requires_grad_(True)
        y = grouped_conv3x3(x, wt, s, b, 32, stride, True)
        gy = torch.randn(y.shape, generator=g, device=g.device).to(y.dtype)
        dx, dw = torch.autograd.grad(y, [x, wt], gy, retain_graph=True)
        # the f32 reference passes the gradient where the bf16 plain forward,
        # which the backward recomputes (as the JAX kernel's custom VJP
        # does), is positive: bf16 and f32 disagree on the sign of outputs
        # near 0, and each such ReLU flip moves a dx entry by a whole tap
        # (0.23 of scale at [1,64,64,1024] in the first card run)
        with torch.no_grad():
            live = reference_grouped_conv3x3(x, wt, s, b, 32, stride) > 0
        xf = x.detach().float().requires_grad_(True)
        wf = wt.detach().float().requires_grad_(True)
        yf = reference_grouped_conv3x3(xf, wf, s, b, 32, stride) * live
        dxf, dwf = torch.autograd.grad(yf, [xf, wf], gy.float())
        cpg = c // 32

        def rel(a, ref):
            return float((a.float() - ref).abs().max() / ref.abs().max())

        errs = {"dx": rel(dx, dxf), "dw": rel(dw, dwf)}
        wrong_group = dwf.reshape(3, 3, cpg, 32, cpg).roll(1, 3).reshape(dwf.shape)
        faults = {"dx_cut": rel(torch.zeros_like(dxf), dxf),
                  "dw_neighbour_group": rel(wrong_group, dwf)}
        ms = cuda_ms(lambda: torch.autograd.grad(y, [x, wt], gy, retain_graph=True))
        out_px = y.shape[0] * y.shape[1] * y.shape[2]
        bound_ms, bound_by = bound(nbytes(x, wt, gy) + nbytes(dx, dw),
                                   2 * 2 * out_px * c * 9 * cpg, BF16_OPS_S)
        row = {"shape": f"x=[{n},{h},{w},{c}] cpg={cpg} stride={stride}",
               "errs": errs, "tol": BWD_GRAD_TOL, "fault_errs": faults,
               "plain_vjp_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 backward (plain VJP) {row['shape']}: dx {errs['dx']:.3e} dw "
              f"{errs['dw']:.3e} of scale (tol {BWD_GRAD_TOL}), ms={ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}); faults "
              + ", ".join(f"{f} {e:.3e}" for f, e in faults.items()), flush=True)
        if not max(errs.values()) <= BWD_GRAD_TOL:
            raise AssertionError(f"K1 backward {row['shape']}: {errs}")
        if not min(faults.values()) > BWD_GRAD_TOL:
            raise AssertionError(f"K1 backward {row['shape']}: a fault passes {faults}")
        out.append(row)
    return out


def check_pool_backward(g, n_rois: int = 384) -> dict:
    """K2 under autograd at the training pool ([1, 64, 64, 1024] map, 384
    RoIs, 14², 1/16, adaptive grid): dfeats in bf16 against the f32 plain
    VJP within BWD_GRAD_TOL of scale, the RoIs' gradient zero, with the cut
    gradient and the RoIs read as (y, x) missing; its time beside its
    bound."""
    import torch

    from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                    batched_roi_align_plain)

    dev = g.device
    feats = torch.relu(torch.randn(1, 64, 64, 1024, generator=g, device=dev)
                       ).to(torch.bfloat16).requires_grad_(True)
    rng = np.random.RandomState(16)
    xy = rng.uniform(0, 900, (n_rois, 2))
    rois_np = np.concatenate([xy, xy + rng.uniform(8, 400, (n_rois, 2))], 1
                             ).clip(0, 1023).astype(np.float32)
    rois = torch.from_numpy(rois_np).to(dev).requires_grad_(True)
    args = (1 / 16, 14, 0, 8)
    y = batched_roi_align(feats, rois, *args)
    gy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
    df, dr = torch.autograd.grad(y, [feats, rois], gy, retain_graph=True)

    def ref_grad(r):
        f32 = feats.detach().float().requires_grad_(True)
        (d,) = torch.autograd.grad(batched_roi_align_plain(f32, r, *args), [f32],
                                   gy.float())
        return d

    want = ref_grad(rois.detach())
    scale = float(want.abs().max())
    err = float((df.float() - want).abs().max()) / scale
    faults = {"dfeats_cut": 1.0,
              "rois_yx": float((ref_grad(rois.detach()[:, [1, 0, 3, 2]]) - want)
                               .abs().max()) / scale}
    ms = cuda_ms(lambda: torch.autograd.grad(y, [feats], gy, retain_graph=True))
    n_bytes, ops = k2_work(tuple(feats.shape), rois_np, *args)
    bound_ms, bound_by = bound(n_bytes, ops, F32_OPS_S)
    row = {"shape": f"feats=[1,64,64,1024] rois={n_rois}", "err": err,
           "tol": BWD_GRAD_TOL, "fault_errs": faults, "rois_grad_zero":
           not bool(dr.any()), "plain_vjp_ms": ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    print(f"K2 backward (plain VJP) {row['shape']}: dfeats {err:.3e} of scale "
          f"(tol {BWD_GRAD_TOL}), RoI gradient zero {row['rois_grad_zero']}, "
          f"ms={ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); faults "
          + ", ".join(f"{f} {e:.3e}" for f, e in faults.items()), flush=True)
    if not (err <= BWD_GRAD_TOL and row["rois_grad_zero"]):
        raise AssertionError(f"K2 backward: {row}")
    if not min(faults.values()) > BWD_GRAD_TOL:
        raise AssertionError(f"K2 backward: a fault passes {faults}")
    return row


def det_step(model, batch, seed: int = 0) -> tuple:
    """One training forward and backward of ``model`` (an AttrRCNNTrainer,
    its trainable leaves requiring grad) on ``batch``, samples from a
    generator seeded with ``seed`` → (losses, {leaf: gradient} of
    DET_GRAD_LEAVES)."""
    import torch

    params = dict(model.named_parameters())
    gen = torch.Generator(device=batch[0].device).manual_seed(seed)
    losses = model(*batch, gen)
    grads = torch.autograd.grad(sum(losses.values()),
                                [params[n] for n in DET_GRAD_LEAVES])
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: gr.float() for n, gr in zip(DET_GRAD_LEAVES, grads)})


def run_detector_training(counters, smi: str, rows: list, dev) -> dict:
    """Phase 16 (see the module docstring): K1's and K2's backward, K5 at
    the RPN's training size, ``train_detector.main --synthetic 1`` for
    DET_STEPS steps at full width, one step against the f32 plain path,
    its device time by kernel family and its memory. Gathers every reading,
    prints it, then raises on the first check that failed."""
    import torch

    from cpt_tpu_torch.engine import detector_train as dt
    from cpt_tpu_torch.models.detector import attr_rcnn, resnet
    from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNNTrainer
    from cpt_tpu_torch.ops.grouped_conv import reference_grouped_conv3x3
    from cpt_tpu_torch.tools import train_detector as td

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    out = {}
    g = torch.Generator(device=dev).manual_seed(16)
    out["k1_backward"] = check_conv_backward(K1_GRAD_SHAPES, g)
    out["k2_backward"] = check_pool_backward(g)
    check_nms(rows, [(1, 12000, 2000, 0.7, 0.0, False)])

    # --- one step on fixed proposals (the bf16 step's, recorded) in bf16
    # and on the f32 plain path, then under each named fault, on the
    # weights the run starts from (the training run's wrapper calls it)
    shapes, step_check = [], {}

    def check_step(model, batch):
        fixed = {}
        real_select = attr_rcnn.select_proposals

        def record(*a, **kw):
            fixed["p"] = tuple(t.detach() for t in real_select(*a, **kw))
            return fixed["p"]

        real_conv = resnet.grouped_conv3x3

        def conv_shapes(x, w33, *a, **kw):
            shapes.append((tuple(x.shape), a[3] if len(a) > 3 else kw.get("stride", 1),
                           x.requires_grad or w33.requires_grad))
            return real_conv(x, w33, *a, **kw)

        cfg = model.config
        dt.set_trainable(model, dt.freeze_mask(list(model.state_dict())))
        attr_rcnn.select_proposals, resnet.grouped_conv3x3 = record, conv_shapes
        try:
            got_losses, got = det_step(model, batch)
        finally:
            resnet.grouped_conv3x3 = real_conv
        attr_rcnn.select_proposals = lambda *a, **kw: fixed["p"]
        try:
            with torch.device(dev):
                oracle = AttrRCNNTrainer(cfg, torch.float32)
            oracle.load_state_dict({k: v.float()
                                    for k, v in model.state_dict().items()})
            dt.set_trainable(oracle, dt.freeze_mask(list(oracle.state_dict())))
            with plain_ops():
                ref_losses, ref = det_step(oracle, batch)
            del oracle
            faults = {}
            for fault in DET_FAULTS:
                with det_fault(fault):
                    faults[fault] = det_step(model, batch)[1]
        finally:
            attr_rcnn.select_proposals = real_select

        def grad_gaps(gr):
            return {n: float((gr[n] - ref[n]).abs().max() / ref[n].abs().max())
                    for n in DET_GRAD_LEAVES}

        loss_gap = max(abs(got_losses[k] - ref_losses[k]) for k in ref_losses)
        gaps = grad_gaps(got)
        fault_gaps = {f: max(grad_gaps(gr).values()) for f, gr in faults.items()}
        check(loss_gap <= DET_LOSS_TOL and max(gaps.values()) <= DET_GRAD_TOL,
              f"detector step against f32: losses {got_losses} / {ref_losses} "
              f"(gap {loss_gap}, tol {DET_LOSS_TOL}), gradients {gaps} (tol "
              f"{DET_GRAD_TOL})")
        check(all(e > DET_GRAD_TOL for e in fault_gaps.values()),
              f"detector step: a fault passes {fault_gaps} (tol {DET_GRAD_TOL})")
        step_check.update({
            "losses": got_losses, "f32": ref_losses, "loss_gap": loss_gap,
            "grad_gaps": gaps, "fault_gaps": fault_gaps,
            "grad_scale": {n: float(ref[n].abs().max()) for n in DET_GRAD_LEAVES},
            "loss_tol": DET_LOSS_TOL, "grad_tol": DET_GRAD_TOL})

    # --- train_detector at full width: every step's launches, host ms and
    # losses; the peak of allocated memory
    argv = ["--synthetic", "1", "--max_iter", str(DET_STEPS), "--device",
            dev.type, "--dtype", "bfloat16", "--output_dir", ""]
    args = td.build_args().parse_args(argv)
    cfg = td.VINVL_X152C4
    anchors = torch.from_numpy(td.grid_anchors(cfg.rpn, cfg.input.pad_h // 16,
                                               cfg.input.pad_w // 16)).to(dev)
    steps, built = [], []
    real_do_train, real_build = td.do_train, td.build_trainer

    def do_train(model, data, **kw):
        check_step(model, next(iter(td.batches(args, model.config, dev, anchors))))
        mark = [time.perf_counter()]

        def on_step(it, total, losses):
            ran = {k: f.launches for k, f in counters.items()}
            steps.append({"step": it, "loss": total, "losses": losses,
                          "launches": ran, "k1_paths": k1_paths(
                              counters, ran, "detector training step"),
                          "ms": (time.perf_counter() - mark[0]) * 1e3})
            zero_counts(counters)
            mark[0] = time.perf_counter()

        zero_counts(counters)
        return real_do_train(model, data, on_step=on_step, **kw)

    real_random = td.dconv.random_vinvl_state_dict
    td.do_train = do_train
    td.build_trainer = lambda *a: built.append(real_build(*a)) or built[-1]
    td.dconv.random_vinvl_state_dict = (
        lambda cfg, seed=0: trainable_weights(real_random(cfg, seed)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = td.main(argv)
    finally:
        td.do_train, td.build_trainer = real_do_train, real_build
        td.dconv.random_vinvl_state_dict = real_random
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model = built[-1]
    per_step = {k: DET_STEP_LAUNCHES.get(k, 0) for k in counters}
    check(state.step == DET_STEPS and len(steps) == DET_STEPS and all(
        np.isfinite(s["loss"]) and s["launches"] == per_step for s in steps),
          f"detector training steps {[(s['loss'], s['launches']) for s in steps]}")
    out["detector_train"] = {
        "launches": {k: sum(s["launches"][k] for s in steps) for k in counters},
        "losses": [s["losses"] for s in steps], "step_ms": [s["ms"] for s in steps],
        "ms_per_step": float(np.mean([s["ms"] for s in steps[1:]])),
        "peak_gib": peak, "run_s": run_s, "k1_paths": steps[-1]["k1_paths"],
        "step_check": step_check}

    # the step's K1 / K2 backward (the plain VJP) timed at each of its
    # shapes, against the bound of the same work
    k1_bwd_ms, k1_bytes, k1_ops = 0.0, 0, 0
    for (shape, stride, needs), count in collections.Counter(shapes).items():
        if not needs:
            continue
        n, h, w, c = shape
        x, wt, s, b = k1_inputs(n, h, w, c, g)
        x.requires_grad_(True)
        wt.requires_grad_(True)
        y = reference_grouped_conv3x3(x, wt, s, b, 32, stride, True)
        gy = torch.randn_like(y)
        k1_bwd_ms += count * cuda_ms(lambda: torch.autograd.grad(
            y, [x, wt], gy, retain_graph=True), reps=3, warmup=1)
        out_px = y.shape[0] * y.shape[1] * y.shape[2]
        k1_bytes += count * (nbytes(x, wt, gy) + nbytes(x, wt))
        k1_ops += count * 2 * 2 * out_px * c * 9 * (c // 32)
        del x, wt, y, gy
    bound_ms, bound_by = bound(k1_bytes, k1_ops, BF16_OPS_S)
    out["detector_train"]["k1_backward_step"] = {
        "plain_vjp_ms": k1_bwd_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "calls_with_grad": sum(cnt for (_, _, nd), cnt in
                               collections.Counter(shapes).items() if nd)}
    k2 = out["k2_backward"]
    out["detector_train"]["k2_backward_step"] = {
        "plain_vjp_ms": 2 * k2["plain_vjp_ms"], "bound_ms": 2 * k2["bound_ms"],
        "bound_by": k2["bound_by"]}

    # device time of one step by kernel family
    batch = next(td.batches(args, cfg, dev, anchors))
    names = list(model.state_dict())
    tx = dt.build_detector_optimizer([dt.jax_path(n) for n in names],
                                     dt.SolverConfig())
    _, leaves = dt.detector_leaves(model)
    st = dt.TrainState(params=leaves, opt_state=tx.init(leaves))
    step_fn = dt.make_detector_train_step(model, tx, dt.freeze_mask(names))
    step_fn(st, batch, torch.Generator(device=dev).manual_seed(1))
    out["detector_train"]["profile"] = profiled(
        lambda: step_fn(st, batch, torch.Generator(device=dev).manual_seed(2)),
        "one detector training step (X152, 1024x1024, bf16)")
    del model, st, step_fn
    phase_s = time.perf_counter() - t_phase
    d = out["detector_train"]
    sc = d["step_check"]
    print(f"phase 16 detector training ({smi}) in {phase_s:.1f} s: "
          f"{DET_STEPS} steps in {d['run_s']:.1f} s, {d['ms_per_step']:.1f} host "
          f"ms/step (each {[round(x, 1) for x in d['step_ms']]}), peak "
          f"{d['peak_gib']:.2f} GiB, launches a step {steps[-1]['launches']}; "
          f"losses {[round(s['loss'], 4) for s in steps]}; one step against f32 "
          f"(fixed proposals): loss gap {sc['loss_gap']:.4e} (tol "
          f"{DET_LOSS_TOL}), gradient gaps "
          + ", ".join(f"{n.split('.')[0]}.{n.split('.')[-2]} {e:.3e}"
                      for n, e in sc["grad_gaps"].items())
          + f" (tol {DET_GRAD_TOL}), faults "
          + ", ".join(f"{f} {e:.3e}" for f, e in sc["fault_gaps"].items())
          + f"; K1 backward a step {d['k1_backward_step']}; K2 backward a step "
          f"{d['k2_backward_step']}", flush=True)
    if failed:
        raise AssertionError(f"phase 16: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 17: the scene-graph path at full width. SceneParser's relation head
# runs over the top SG_REL_DETS detections, every ordered pair of them: 240
# union boxes pooled by K2 from the C4 map and run through a stage-5 head
# (K1 at [240,14,14,2048] stride 2, then [240,7,7,2048]).
SG_IMAGES = 2
SG_STEPS = 5
# train_detector --sg's rate for phase 17's steps: at the default 0.01 the
# random relation head over the random detector's features diverged
# (losses 0.73 → 64.5 in 5 steps, the calibration run)
SG_BASE_LR = 1e-3
SG_REL_DETS = 16
SG_PREDICATES = ("on", "near", "has", "wearing", "behind")
K1_UNION_SHAPES = [(240, 14, 14, 2048, 2), (240, 7, 7, 2048, 1)]
# a SceneParser image: the backbone once (47), the box head's and the
# relation head's stage 5 (3 each); the box head's and the union boxes'
# pooling; the RPN's and the post-processor's NMS. A training step: the
# backbone, both stage 5s, both poolings, no NMS (forced boxes).
SG_IMAGE_LAUNCHES = {"K1": 53, "K2": 2, "K5": 2}
SG_STEP_LAUNCHES = {"K1": 53, "K2": 2}
# rel_logits of the bf16 kernel path against the f32 plain path on the same
# detections (the detector's bf16 map and outputs, cast), as the largest
# |Δ| over the largest |logit|, per algorithm, on ``sg_tsv``'s first image
# (its objects painted, decoded from the writer's quality-95 JPEG row) with
# the gates shifted (``sg_break_symmetry``). This script on the H100 80GB
# HBM3 at 700 W (PERF.md, PR 24; cuBLAS's bf16 reductions in f32) read
# 8.470e-3 (RelDN), 1.155e-2 (IMP), 1.633e-2 (MSDN), 6.571e-3 (GRCNN) and
# 1.430e-2 (motif: bf16 LSTMs); each tolerance lies between 1.3× and 3.0×
# its gap and below its faults' smallest: IMP's subject/object swap 2.432e-2
# (1.22× its tolerance), MSDN's 2.539e-2 (1.15×), GRCNN's swap 3.408e-2
# (2.27×), the motif's intersection 3.272e-2 (1.49×). MSDN's and the
# motif's were 3.5e-2 while the images were lossless noise (gaps 1.627e-2
# and 2.212e-2, faults 5.616e-2 and 4.659e-2 there); on the decoded JPEGs
# those two faults read under 3.5e-2, so both came down to 2.2e-2.
SG_TOL = {"sg_reldn": 2.5e-2, "sg_imp": 2e-2, "sg_msdn": 2.2e-2,
          "sg_grcnn": 1.5e-2, "sg_nm": 2.2e-2}
# One step's relation loss (nats) and the SG_GRAD_LEAVES gradients (largest
# |Δ| over largest |g|) at the relation head's init, bf16 against f32, on
# the decoded JPEG rows. The H100 run (PERF.md, PR 24): loss 2.028e-4 from
# f32; gradients 1.828e-2 to 3.248e-1, the largest ``rel_embedding_0``'s,
# where bf16 and f32 put some LeakyReLU inputs on opposite sides of 0 (as
# phase 16's ReLUs): the plain path in bf16, no kernel, reads 3.421e-1
# there (``sg_step_check`` prints it), so that gap is bf16's, not a kernel's.
# K1's dx cut reads 1.0. 0.5 is 1.46× the plain bf16 path's gap and 2×
# under the fault; it was 0.25 while the images were lossless noise
# (largest gap 1.230e-1, loss 3.862e-4; the loss tolerance stays 2e-3).
SG_LOSS_TOL = 2e-3
SG_GRAD_TOL = 5e-1
# Named faults of the relation path on the f32 path, each of which must
# move rel_logits beyond its algorithm's SG_TOL (a NaN counts as moved):
# the union box taken as the intersection, subject and object swapped,
# RelDN's frequency prior dropped, the motif LSTMs' input and forget gates
# swapped. On an unpainted noise image at flax's init MSDN's swap moved the
# logits by 2.884e-3 (its gates weigh subject and object alike there) and
# the motif's intersection by 2.187e-2, both under their gaps: the painted
# objects and the gate shift put every one above (the readings above).
SG_FAULTS = {"sg_reldn": ("union_as_intersection", "subject_object_swapped",
                          "freq_prior_dropped"),
             "sg_imp": ("union_as_intersection", "subject_object_swapped"),
             "sg_msdn": ("union_as_intersection", "subject_object_swapped"),
             "sg_grcnn": ("union_as_intersection", "subject_object_swapped"),
             "sg_nm": ("union_as_intersection", "subject_object_swapped",
                       "lstm_if_swapped")}
# The shift of the relation heads' gate biases (``sg_break_symmetry``): at
# 4.0 MSDN's swap moves the calibration image's logits by 5.616e-2, 1.60×
# its tolerance (a smaller shift left it under)
SG_GATE_SHIFT = 4.0
SG_GRAD_LEAVES = ("relation.pred_feature_extractor.layer4.block_0.conv1.weight",
                  "relation.pred_feature_extractor.layer4.block_0.conv2.weight",
                  "relation.pred_feature_extractor.layer4.block_2.conv3.weight",
                  "relation.rel_embedding_0.kernel",
                  "relation.spatial_0.kernel")
SG_LABELMAP = dict(DETECTOR_LABELMAP, predicate_to_idx={
    p: i + 1 for i, p in enumerate(SG_PREDICATES)})


def sg_union_rois(n_dets: int = SG_REL_DETS, size: int = 1024) -> np.ndarray:
    """The union boxes of every ordered pair of ``n_dets`` detection-like
    boxes on the ``size`` canvas ([n(n-1), 4] f32), the K2 launch of the
    relation head: union boxes span much of the image, so the adaptive grid
    takes up to 5 samples a bin axis. The first is replaced by one reaching
    past the canvas, as ``k2_shapes``' 32-RoI launch has, so that
    ``clamp_not_skip`` and ``count_in_range`` show."""
    rng = np.random.RandomState(17)
    xy = rng.uniform(0, size * 0.85, (n_dets, 2))
    boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, 300, (n_dets, 2)),
                                           size - 1)], 1)
    i, j = np.nonzero(~np.eye(n_dets, dtype=bool))
    rois = np.concatenate([np.minimum(boxes[i, :2], boxes[j, :2]),
                           np.maximum(boxes[i, 2:], boxes[j, 2:])], 1).astype(
        np.float32)
    rois[0] = [-300.0, -200.0, 1500.0, 1000.0]
    return rois


def sg_tsv(root: str, size: int, n: int = SG_IMAGES) -> str:
    """A VG-TSV of ``n`` random ``size × size`` images with 6-10 objects of
    SG_LABELMAP's classes and 4-8 relations each (``write_detection_tsv``)
    → its yaml. Each object's rect is painted one random colour over the
    noise, so that what a box pools depends on where it lies (on noise
    alone the union and the intersection of two boxes pool alike after
    stage 5). The image rows are the writer's quality-95 JPEGs, so the
    heads see the arrays ``utils/image_codec`` decodes from them."""
    from cpt_tpu_torch.data.vg_tsv import write_detection_tsv

    rng = np.random.RandomState(17)
    names = list(SG_LABELMAP["label_to_idx"])
    images, labels = {}, {}
    for i in range(n):
        images[f"img{i}"] = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        n_obj = rng.randint(6, 11)
        objects = []
        for _ in range(n_obj):
            xy = rng.uniform(0, size * 0.7, 2)
            wh = rng.uniform(size * 0.05, size * 0.3, 2)
            objects.append({"rect": [float(v) for v in np.concatenate([xy, xy + wh])],
                            "class": names[rng.randint(len(names))],
                            "attributes": []})
            x0, y0, x1, y1 = (int(v) for v in objects[-1]["rect"])
            images[f"img{i}"][y0:y1, x0:x1] = rng.randint(0, 256, 3)
        pairs = [(s, o) for s in range(n_obj) for o in range(n_obj) if s != o]
        pick = rng.choice(len(pairs), rng.randint(4, 9), replace=False)
        labels[f"img{i}"] = {"objects": objects, "relations": [
            {"subj_id": int(pairs[p][0]), "obj_id": int(pairs[p][1]),
             "class": SG_PREDICATES[rng.randint(len(SG_PREDICATES))]}
            for p in pick]}
    return write_detection_tsv(root, "rel", images, labels, SG_LABELMAP)


@contextlib.contextmanager
def sg_fault(fault: str, model):
    """One of SG_FAULTS on ``model`` (a SceneParser) meanwhile."""
    import torch

    from cpt_tpu_torch.models.detector import relation_head, scene_parser

    if fault == "union_as_intersection":
        real, mod, name = relation_head.boxes_union, relation_head, "boxes_union"

        def patched(a, b):
            return torch.stack([torch.maximum(a[..., 0], b[..., 0]),
                                torch.maximum(a[..., 1], b[..., 1]),
                                torch.minimum(a[..., 2], b[..., 2]),
                                torch.minimum(a[..., 3], b[..., 3])], dim=-1)
    elif fault == "subject_object_swapped":
        real, mod, name = scene_parser.all_pairs, scene_parser, "all_pairs"

        def patched(*a, **kw):
            return real(*a, **kw).flip(1)
    elif fault == "lstm_if_swapped":
        cells = [m for m in model.modules() if isinstance(m, torch.nn.LSTMCell)]
        saved = [{k: v.clone() for k, v in c.state_dict().items()} for c in cells]
        with torch.no_grad():
            for c in cells:
                h = c.hidden_size
                for t in (c.weight_ih, c.weight_hh, c.bias_hh):
                    t.copy_(torch.cat([t[h:2 * h], t[:h], t[2 * h:]]))
        try:
            yield
        finally:
            for c, sd in zip(cells, saved):
                c.load_state_dict(sd)
        return
    elif fault == "freq_prior_dropped":
        yield                            # the caller passes no prior
        return
    else:
        raise ValueError(f"unknown scene-graph fault {fault!r}")
    setattr(mod, name, patched)
    try:
        yield
    finally:
        setattr(mod, name, real)


def f32_relation_twin(model):
    """A SceneParser on ``model``'s detector (shared) whose relation head is
    an f32 copy of ``model``'s: the plain path's oracle."""
    import torch

    from cpt_tpu_torch.models.detector.scene_parser import SceneParser

    dev = next(model.parameters()).device
    with torch.device(dev):
        twin = SceneParser(model.config, model.num_rel_classes,
                           model.max_rel_dets, model.algorithm, torch.float32,
                           detector=model.detector)
    twin.load_state_dict({k: v.detach().float() for k, v in
                          model.relation_parameters().items()}, strict=False)
    return twin.eval()


def floated(d: dict) -> dict:
    return {k: v.float() if v.is_floating_point() else v for k, v in d.items()}


def sg_rel_gaps(model, feat, det, hw, freq) -> dict:
    """rel_logits of ``model`` (bf16, kernels) on one image's detector map
    ``feat`` and outputs ``det`` against its f32 twin's on the plain path,
    and each of its SG_FAULTS on the twin: {"gap", "faults", "scale"}."""
    import torch

    twin = f32_relation_twin(model)
    prior = freq if model.algorithm == "sg_reldn" else None
    with torch.no_grad():
        got = model.relation_outputs(feat, det, hw, prior)["rel_logits"].float()
        f_feat, f_det = feat.float(), floated(det)
        with plain_ops():
            want = twin.relation_outputs(f_feat, f_det, hw, prior)["rel_logits"]
            faults = {}
            for fault in SG_FAULTS[model.algorithm]:
                with sg_fault(fault, twin):
                    p = None if fault == "freq_prior_dropped" else prior
                    faults[fault] = twin.relation_outputs(
                        f_feat, f_det, hw, p)["rel_logits"]
    scale = float(want.abs().max())
    rel = {f: float((v - want).abs().max()) / scale for f, v in faults.items()}
    del twin
    return {"gap": float((got - want).abs().max()) / scale, "faults": rel,
            "scale": scale, "finite": bool(torch.isfinite(got).all())}


def sg_step_check(model, batch, freq) -> dict:
    """One relation-loss step of ``model`` (bf16, kernels) on ``batch``
    against its f32 twin on the plain path, the detector's outputs shared:
    the loss gap (nats) and the SG_GRAD_LEAVES gradients' gaps, with K1's
    dx cut (``det_fault``) missing SG_GRAD_TOL; beside them the plain path's
    own gaps in bf16 (no kernel), read and not checked."""
    import torch

    image, hw, boxes, labels, valid, rels, rel_valid = batch
    with torch.no_grad():
        feat, det = model.detector_outputs(image, boxes, valid)

    def run(m, frozen):
        params = m.relation_parameters()
        for n in SG_GRAD_LEAVES:
            params[n].requires_grad_(True)
        loss = m.relation_train_loss(image, hw, boxes, labels, valid, rels,
                                     boxes, rel_valid, freq, frozen=frozen)
        grads = torch.autograd.grad(loss, [params[n] for n in SG_GRAD_LEAVES])
        return float(loss.detach()), {n: g.float() for n, g in
                                      zip(SG_GRAD_LEAVES, grads)}

    loss, grads = run(model, (feat, det))
    with det_fault("k1_dx_cut"):
        _, cut = run(model, (feat, det))
    with plain_ops():
        _, plain = run(model, (feat, det))
    twin = f32_relation_twin(model)
    with plain_ops():
        ref_loss, ref = run(twin, (feat.float(), floated(det)))
    del twin

    def gaps(gr):
        return {n: float((gr[n] - ref[n]).abs().max() / ref[n].abs().max())
                for n in SG_GRAD_LEAVES}

    return {"loss": loss, "f32": ref_loss, "loss_gap": abs(loss - ref_loss),
            "grad_gaps": gaps(grads), "fault_gap": max(gaps(cut).values()),
            "plain_grad_gaps": gaps(plain),
            "grad_scale": {n: float(ref[n].abs().max()) for n in SG_GRAD_LEAVES}}


def sg_break_symmetry(model) -> None:
    """Moves a SceneParser's relation head off the symmetric point of
    flax's init, where every gate's bias is 0 and sigmoid(0) weighs a
    pair's subject and object alike: the biases of the subject's gates
    (IMP's ``subj_*_gate``, MSDN's ``gate_*sub*``) shifted by
    +SG_GATE_SHIFT, the object's by −SG_GATE_SHIFT."""
    import torch

    with torch.no_grad():
        for name, t in model.relation_parameters().items():
            if "gate" in name and name.endswith("bias"):
                layer = [p for p in name.split(".") if "gate" in p][-1]
                t.add_(SG_GATE_SHIFT if "sub" in layer else -SG_GATE_SHIFT)


def sg_head_checks(cfg, model, image, hw, anchors, counters, rel_dets: int,
                   g, check) -> dict:
    """Phase 17's check of each algorithm on one image: one forward
    (launches), rel_logits against the f32 plain path on the same
    detections, the named faults. RelDN's prior is indexed by the
    detector's labels, so it spans the detector's classes (the dataset's
    prior spans its own 6): one drawn from ``g``, normalised over the
    predicates. Each head starts from its init, then
    :func:`sg_break_symmetry`."""
    import torch

    from cpt_tpu_torch.models.detector import scene_parser as sp

    dev = image.device
    on_card = dev.type == "cuda"
    n_cls = cfg.roi_heads.num_classes
    det_freq = torch.rand(n_cls, n_cls, model.num_rel_classes,
                          generator=g, device=dev)
    det_freq /= det_freq.sum(-1, keepdim=True)
    with torch.no_grad():
        feat = model.detector.features(image.to(model.dtype))
        det = model.detector.detect_from_feats(feat, hw, anchors, False)
    heads = {}
    for alg in sp.ALGORITHMS:
        with torch.device(dev):
            m = sp.SceneParser(cfg, model.num_rel_classes, rel_dets,
                               alg, model.dtype, detector=model.detector)
        m.init_relation(torch.Generator().manual_seed(17))
        sg_break_symmetry(m)
        m.eval()
        zero_counts(counters)
        t = time.perf_counter()
        with torch.no_grad():
            o = m(image, hw, anchors, det_freq)
        if on_card:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        ran = {k: c.launches for k, c in counters.items()}
        r = sg_rel_gaps(m, feat, det, hw, det_freq)
        r.update({"ms": ms, "launches": ran,
                  "valid_pairs": int(o["pair_valid"].sum())})
        heads[alg] = r
        tol = SG_TOL[alg]
        check(r["finite"] and r["gap"] <= tol,
              f"{alg} rel_logits against f32: {r['gap']} (tol {tol})")
        check(not any(e <= tol for e in r["faults"].values()),
              f"{alg}: a fault passes {r['faults']} (tol {tol})")
        check(ran == {k: SG_IMAGE_LAUNCHES.get(k, 0) for k in counters},
              f"{alg} forward launches {ran}")
        print(f"SceneParser {alg}: rel_logits gap to f32 {r['gap']:.3e} "
              f"of scale {r['scale']:.3e} (tol {tol}); faults "
              + ", ".join(f"{f} {e:.3e} ({e / tol:.2f}x tol)"
                          for f, e in r["faults"].items())
              + f"; {ms:.2f} host ms, launches {ran}, valid pairs "
              f"{r['valid_pairs']}", flush=True)
        del m
    return heads


def run_scene_graph(counters, smi: str, rows: list, dev, tiny: bool = False) -> dict:
    """Phase 17 (see the module docstring). ``tiny``: the tiny detector in
    f32 on ``dev`` (a dry run of the code paths on the CPU; the launch and
    kernel checks fail there). Gathers every reading, prints it, then
    raises on the first check that failed."""
    import torch

    from cpt_tpu_torch.data.vg_tsv import VGTSVDataset
    from cpt_tpu_torch.engine import bbox_aug
    from cpt_tpu_torch.models.detector import scene_parser as sp
    from cpt_tpu_torch.ops.nms import nms_padded
    from cpt_tpu_torch.tools import test_detector as tdet
    from cpt_tpu_torch.tools import train_detector as td

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    out = {}
    on_card = dev.type == "cuda"
    flags = (["--tiny", "--dtype", "float32"] if tiny
             else ["--dtype", "bfloat16"]) + ["--device", dev.type]
    cfg = td.tiny_detector_config() if tiny else td.VINVL_X152C4
    size = cfg.input.pad_h
    rel_dets = 4 if tiny else SG_REL_DETS
    g = torch.Generator(device=dev).manual_seed(17)
    if on_card:
        out["k1_union_backward"] = check_conv_backward(K1_UNION_SHAPES[:1], g)
    real_random = td.dconv.random_vinvl_state_dict
    td.dconv.random_vinvl_state_dict = (
        lambda c, seed=0: trainable_weights(real_random(c, seed)))
    real_forward = sp.SceneParser.forward
    try:
        with tempfile.TemporaryDirectory() as root:
            yaml_path = sg_tsv(f"{root}/sg", size)
            ds = VGTSVDataset(yaml_path, attribute_on=False, relation_on=True)
            freq = torch.from_numpy(ds.compute_freq_prior()).to(dev)

            # --- test_detector --sg: each SceneParser image's launches and
            # host ms; the parser kept for the checks below
            images, built = [], []

            def forward(self, image, image_hw, anchors, freq_prior=None):
                zero_counts(counters)
                t = time.perf_counter()
                o = real_forward(self, image, image_hw, anchors, freq_prior)
                if on_card:
                    torch.cuda.synchronize()
                images.append({"ms": (time.perf_counter() - t) * 1e3,
                               "launches": {k: c.launches for k, c in counters.items()},
                               "args": (image, tuple(image_hw), anchors)})
                return o

            real_build = tdet.build_scene_parser
            sp.SceneParser.forward = forward
            tdet.build_scene_parser = lambda *a: built.append(real_build(*a)) or built[-1]
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            try:
                results, ok = tdet.main(flags + ["--tsv", yaml_path, "--sg",
                                                 "--max_rel_dets", str(rel_dets)])
            finally:
                sp.SceneParser.forward = real_forward
                tdet.build_scene_parser = real_build
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
            sg_keys = {k: v for k, v in results.items() if k.startswith("sg_")}
            check(ok and len(sg_keys) == 6 and all(np.isfinite(v) for v in sg_keys.values()),
                  f"test_detector --sg results {results}")
            check(len(images) == SG_IMAGES and all(
                im["launches"] == {k: SG_IMAGE_LAUNCHES.get(k, 0) for k in counters}
                for im in images), f"SG image launches {[im['launches'] for im in images]}")
            model = built[0]
            image, hw, anchors = images[0]["args"]
            profile = (profiled(lambda: real_forward(model, image, hw, anchors),
                                "one SceneParser image (sg_reldn, X152, 1024x1024)")
                       if on_card else {})
            out["sg_infer"] = {
                "results": sg_keys, "ms_per_image": [im["ms"] for im in images],
                "launches": {k: sum(im["launches"][k] for im in images)
                             for k in counters},
                "image_launches": images[-1]["launches"], "peak_gib": peak,
                "profile": profile}
            print(f"test_detector --sg over {SG_IMAGES} images: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in sorted(sg_keys.items()))
                  + "; SceneParser host ms per image "
                  + ", ".join(f"{im['ms']:.2f}" for im in images)
                  + f"; launches per image {images[-1]['launches']}; peak "
                  f"{peak:.2f} GiB", flush=True)

            # --- each algorithm: one forward (launches), rel_logits against
            # the f32 plain path on the same detections, the named faults.
            # RelDN's prior is indexed by the detector's labels, so it spans
            # the detector's classes (the dataset's prior spans its own 6):
            # one drawn from a seed, normalised over the predicates
            heads = sg_head_checks(cfg, model, image, hw, anchors, counters,
                                   rel_dets, g, check)
            out["sg_heads"] = heads
            del model, built
            if on_card:
                torch.cuda.empty_cache()

            # --- train_detector --sg: every step's launches, host ms, loss;
            # the peak of allocated memory; one step against f32
            steps, parsers = [], []
            real_train, real_parser = td.train_scene_graph, td.build_scene_parser
            mark = [time.perf_counter()]

            def on_step(i, loss):
                loss = float(loss)
                steps.append({"step": i, "loss": loss,
                              "launches": {k: c.launches for k, c in counters.items()},
                              "ms": (time.perf_counter() - mark[0]) * 1e3})
                zero_counts(counters)
                mark[0] = time.perf_counter()

            def train(*a, **kw):
                zero_counts(counters)
                mark[0] = time.perf_counter()
                return real_train(*a, on_step=on_step, **kw)

            # one step at the relation head's init against f32, on the run's
            # first batch, before its optimizer exists
            args = td.build_args().parse_args(flags + ["--tsv", yaml_path, "--sg",
                                                       "--max_rel_dets", str(rel_dets)])
            batch = next(td.sg_samples(args, cfg, ds, dev))
            step_check, real_make = {}, td.make_sg_train_step

            def make(parser, solver, prior):
                step_check.update(sg_step_check(parser, batch, prior))
                zero_counts(counters)
                mark[0] = time.perf_counter()
                return real_make(parser, solver, prior)

            td.train_scene_graph, td.make_sg_train_step = train, make
            td.build_scene_parser = lambda *a: parsers.append(real_parser(*a)) or parsers[-1]
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            try:
                parser, losses = td.main(flags + [
                    "--tsv", yaml_path, "--sg", "--max_iter", str(SG_STEPS),
                    "--base_lr", str(SG_BASE_LR), "--max_rel_dets",
                    str(rel_dets), "--output_dir", ""])
            finally:
                td.train_scene_graph, td.build_scene_parser = real_train, real_parser
                td.make_sg_train_step = real_make
            run_s = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
            per_step = {k: SG_STEP_LAUNCHES.get(k, 0) for k in counters}
            check(len(steps) == SG_STEPS and all(
                np.isfinite(s["loss"]) and s["launches"] == per_step for s in steps),
                f"SG training steps (loss, launches) {[(s['loss'], s['launches']) for s in steps]}")
            check(step_check["loss_gap"] <= SG_LOSS_TOL
                  and max(step_check["grad_gaps"].values()) <= SG_GRAD_TOL,
                  f"SG step against f32: {step_check}")
            check(step_check["fault_gap"] > SG_GRAD_TOL,
                  f"SG step: K1's dx cut passes {step_check['fault_gap']}")
            step_fn = td.make_sg_train_step(parser, td.sg_solver(args, None), freq)
            step_fn(batch)
            # torch.profiler drops launches from some traces late in a long
            # process (ROADMAP, Queue 3): two traces, the fuller one kept
            profile = (max((profiled(lambda: step_fn(batch),
                                     "one SG training step (sg_reldn, X152, "
                                     "1024x1024, bf16)") for _ in range(2)),
                           key=lambda p: p["device_ms"]) if on_card else {})
            out["sg_train"] = {
                "launches": {k: sum(s["launches"][k] for s in steps) for k in counters},
                "losses": [s["loss"] for s in steps],
                "step_ms": [s["ms"] for s in steps],
                "ms_per_step": float(np.mean([s["ms"] for s in steps[1:]])),
                "peak_gib": peak, "run_s": run_s, "step_check": step_check,
                "profile": profile}
            del parser, parsers, step_fn
            if on_card:
                torch.cuda.empty_cache()
            sc = step_check
            print(f"train_detector --sg: {SG_STEPS} steps in {run_s:.1f} s, "
                  f"host ms/step {[round(s['ms'], 1) for s in steps]}, peak "
                  f"{peak:.2f} GiB, launches a step {steps[-1]['launches']}; "
                  f"losses {[round(s['loss'], 4) for s in steps]}; one step "
                  f"against f32: loss {sc['loss']:.5f} vs {sc['f32']:.5f} (gap "
                  f"{sc['loss_gap']:.3e}, tol {SG_LOSS_TOL}), gradient gaps "
                  + ", ".join(f"{n.split('.')[-2]}.{n.split('.')[-1]} {e:.3e}"
                              for n, e in sc["grad_gaps"].items())
                  + f" (tol {SG_GRAD_TOL}), K1 dx cut {sc['fault_gap']:.3e}; "
                  "the plain path in bf16 "
                  + ", ".join(f"{n.split('.')[-2]} {e:.3e}"
                              for n, e in sc["plain_grad_gaps"].items()),
                  flush=True)

        # --- test_detector --bbox_aug, hflip alone, then with
        # --bbox_aug_scales 0.75,1.25 (rescaled by utils/image_ops): each
        # merge's K5 launch against plain nms_padded on its own inputs; K1 50,
        # K2 1, K5 2 a pass and K5 1 a merge
        real_nms = bbox_aug.nms_pallas
        for key, extra, passes in (("bbox_aug", [], 2),
                                   ("bbox_aug_scales",
                                    ["--bbox_aug_scales", "0.75,1.25"], 4)):
            merges = []

            def nms(boxes, scores, valid, thr, max_out):
                idx, keep = real_nms(boxes, scores, valid, thr, max_out)
                merges.append((boxes, scores, valid, thr, max_out, idx, keep))
                return idx, keep

            bbox_aug.nms_pallas = nms
            zero_counts(counters)
            t = time.perf_counter()
            try:
                aug, ok = tdet.main(flags + ["--synthetic", str(SG_IMAGES),
                                             "--bbox_aug", *extra])
            finally:
                bbox_aug.nms_pallas = real_nms
            aug_s = time.perf_counter() - t
            ran = {k: c.launches for k, c in counters.items()}
            exact = []
            for boxes, scores, valid, thr, max_out, idx, keep in merges:
                want_idx, want_keep = nms_padded(boxes, scores, valid, thr,
                                                 max_out)
                exact.append(bool(torch.equal(keep, want_keep) and torch.equal(
                    idx[keep], want_idx[want_keep])))
            ks = [int(m[0].shape[0]) for m in merges]
            label = " ".join(["--bbox_aug", *extra])
            check(ok and np.isfinite(aug["mAP"]) and len(merges) == SG_IMAGES
                  and all(exact),
                  f"{label}: mAP {aug}, merges K {ks} exact {exact}")
            check(ran["K5"] == SG_IMAGES * (2 * passes + 1)
                  and ran["K1"] == SG_IMAGES * 50 * passes
                  and ran["K2"] == SG_IMAGES * passes, f"{label} launches {ran}")
            if on_card and ks:
                check_nms(rows, [(1, max(ks), 100, 0.5, 0.0, False)])
            out[key] = {"mAP": aug["mAP"], "merge_k": ks, "exact": exact,
                        "seconds": aug_s, "launches": ran}
            print(f"test_detector {label} ({passes} passes an image) over "
                  f"{SG_IMAGES} images: mAP {aug['mAP']:.4f} in {aug_s:.2f} s; "
                  f"merge K {ks}, K5 equal to nms_padded {exact}; launches "
                  f"{ran}", flush=True)
    finally:
        td.dconv.random_vinvl_state_dict = real_random
        sp.SceneParser.forward = real_forward
    phase_s = time.perf_counter() - t_phase
    print(f"phase 17 scene graphs ({smi}) in {phase_s:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 17: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 18, the detector library modules at full width: a ResNetFPN at the
# VinVL X152 widths with a fourth stage (3, 8, 36, 3) and 256 FPN channels
# on one 640×1024 canvas, random weights from a seed. K1 at the fourth
# stage's two new shapes (cpg 64: its first block's stride-2 3×3 on the
# 40×64 C4 map, then 20×32), K2 on each of the four pooling levels
# (1000 RoIs, 7², a fixed 2×2 grid, scales 1/4 to 1/32), K5 on the
# RetinaNet merge (5 levels × 1000 candidates → 100, coordinates shifted by
# class · 1025 up to 80 · 1025).
LIB_CANVAS = (640, 1024)
FPN_STAGE_BLOCKS = (3, 8, 36, 3)
FPN_CHANNELS = 256
FPN_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
FPN_STRIDES = (4, 8, 16, 32, 64)
LIB_ROIS = 1000
LIB_MASKS = 100
LIB_CLASSES = 80
LIB_KEYPOINTS = 17
RETINA_TOP_N = 1000
RETINA_NMS_THR = 0.4
RETINA_MAX_DET = 100
K1_FPN_SHAPES = [(1, 40, 64, 2048, 2), (1, 20, 32, 2048, 1)]
# one pass of each path: the ResNetFPN body's 50 bottlenecks (K1), the four
# levels' pooling (K2), the RetinaNet merge (K5); the heads, MsViT, FBNet
# and DFConv2d run plain torch (no kernel of the JAX package's either)
LIB_LAUNCHES = {"fpn": {"K1": 50}, "pool": {"K2": 4}, "retina": {"K5": 1},
                "heads": {}, "other_modules": {}}


def random_module_weights(module, seed: int) -> None:
    """Every float parameter and buffer of ``module`` drawn from ``seed`` on
    its device: kernels N(0, 1/fan-in) by the layout of their layer (OIHW
    convs, the HWIO grouped 3×3, torch's [in, out, k, k] transposed convs,
    [in, out] Denses, DFConv2d's [k, k, C, out]), frozen-BN / LayerNorm /
    ``*_scale`` scales U(0.5, 1), every other tensor (biases, tables,
    embeddings) N(0, 0.05²)."""
    import torch

    from cpt_tpu_torch.models.bert.model import Dense
    from cpt_tpu_torch.models.detector.extra_heads import ConvTranspose
    from cpt_tpu_torch.models.detector.resnet import (Conv, Conv2d,
                                                      GroupedConv3x3)
    from cpt_tpu_torch.ops.deform_conv import DFConv2d

    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            tensors = list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False))
            for name, t in tensors:
                if not t.is_floating_point():
                    continue
                shape = t.shape
                fan_in = None
                if name == "weight" and isinstance(mod, (Conv, Conv2d)):
                    fan_in = shape[1] * shape[2] * shape[3]
                elif name == "weight" and isinstance(mod, GroupedConv3x3):
                    fan_in = shape[0] * shape[1] * shape[2]
                elif name == "weight" and isinstance(mod, ConvTranspose):
                    fan_in = shape[0] * shape[2] * shape[3] // mod.stride ** 2
                elif name == "kernel" and isinstance(mod, Dense):
                    fan_in = shape[0]
                elif name == "kernel" and isinstance(mod, DFConv2d):
                    fan_in = shape[0] * shape[1] * shape[2]
                if fan_in is not None:
                    v = torch.randn(shape, generator=g, device=dev) / fan_in ** 0.5
                elif name.endswith("scale"):
                    v = torch.rand(shape, generator=g, device=dev) * 0.5 + 0.5
                else:
                    v = torch.randn(shape, generator=g, device=dev) * 0.05
                t.copy_(v.to(t.dtype))


def library_rois(n: int = LIB_ROIS, seed: int = 18) -> np.ndarray:
    """[n, 4] f32 boxes on the LIB_CANVAS (4 to 600 pixels a side, so every
    pyramid level takes some), the first replaced by one reaching past the
    canvas on every side (``clamp_not_skip`` and ``count_in_range`` show on
    it)."""
    rng = np.random.RandomState(seed)
    h, w = LIB_CANVAS
    xy = rng.uniform(0, [w - 8, h - 8], (n, 2))
    side = np.exp(rng.uniform(np.log(4), np.log(600), (n, 2)))
    rois = np.concatenate([xy, np.minimum(xy + side, [w - 1, h - 1])], 1)
    rois[0] = [-300.0, -200.0, w + 400.0, h + 300.0]
    return rois.astype(np.float32)


def retina_merge_inputs(k: int = 5 * RETINA_TOP_N, seed: int = 19) -> tuple:
    """K5's inputs at the RetinaNet merge: ``nms_inputs``' boxes (its tied
    scores, planted pairs at IoU exactly RETINA_NMS_THR, suppression chain
    and invalid fifth), the random ones clipped to the canvas and the
    planted ones moved into it, each shifted by its class · (1024 + 1) as
    ``retinanet_select`` shifts them, classes 1..80 (the planted boxes all
    80: coordinates up to ~8.3e4, where f32 keeps 2^-7)."""
    boxes, scores, valid = nms_inputs(1, k, RETINA_NMS_THR, seed=seed)
    h, w = LIB_CANVAS
    boxes[0, :19] -= 1000.0
    boxes[0, 19:] = np.minimum(boxes[0, 19:], [w - 1, h - 1, w - 1, h - 1])
    labels = np.random.RandomState(seed).randint(1, LIB_CLASSES + 1, (1, k))
    labels[:, :19] = LIB_CLASSES
    boxes = boxes + (labels * float(max(LIB_CANVAS) + 1))[..., None]
    return boxes.astype(np.float32), scores, valid


def check_library_kernels(rows: list, g) -> None:
    """K1 at K1_FPN_SHAPES, K2 on the four FPN levels (1000 RoIs, 7²,
    sampling 2), K5 on the RetinaNet merge's inputs: each against its plain
    version and its named faults, by device time."""
    import torch

    from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                    batched_roi_align_plain)

    check_k1(rows, K1_FPN_SHAPES, g, device=("grouped_conv3x3_mma",))
    rois = library_rois()
    rois_t = torch.from_numpy(rois).cuda()
    h, w = LIB_CANVAS
    for scale in FPN_SCALES:
        shape = (1, int(h * scale), int(w * scale), FPN_CHANNELS)
        feats = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        compare("K2", f"FPN level 1/{round(1 / scale)}: feats={list(shape)} "
                f"rois={len(rois)} pooled=7 sampling=2",
                lambda: batched_roi_align(feats, rois_t, scale, 7, 2, 8),
                lambda: batched_roi_align_plain(feats, rois_t, scale, 7, 2, 8),
                lambda: batched_roi_align_plain(feats.float(), rois_t, scale,
                                                7, 2, 8),
                rows, k2_faults(feats, rois_t, scale, 7, 2, 8),
                work=k2_work(shape, rois, scale, 7, 2, 8) + (F32_OPS_S,),
                device="roi_align")
    check_nms_on(rows, f"RetinaNet merge boxes=[{5 * RETINA_TOP_N},4] "
                 f"max_out={RETINA_MAX_DET} thr={RETINA_NMS_THR} class "
                 f"offsets to {LIB_CLASSES * (max(LIB_CANVAS) + 1)}",
                 retina_merge_inputs(), RETINA_NMS_THR, RETINA_MAX_DET)


def run_library_modules(counters, smi: str, rows: list, dev,
                        tiny: bool = False) -> dict:
    """Phase 18 (see the module docstring). ``tiny``: narrow widths in f32
    on ``dev`` (a dry run of the code paths on the CPU; the launch and
    kernel checks fail there). Gathers every reading, prints it, then
    raises on the first check that failed."""
    import dataclasses as dc

    import torch

    from cpt_tpu_torch.engine.cityscapes_eval import cityscapes_instance_eval
    from cpt_tpu_torch.models.detector import extra_heads as eh
    from cpt_tpu_torch.models.detector.config import (VINVL_X152C4,
                                                      tiny_detector_config)
    from cpt_tpu_torch.models.detector.fbnet import FBNetTrunk
    from cpt_tpu_torch.models.detector.fpn import (ResNetFPN,
                                                   multilevel_roi_align)
    from cpt_tpu_torch.models.detector.msvit import MsViT
    from cpt_tpu_torch.ops.deform_conv import DFConv2d

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    dt = torch.bfloat16 if on_card and not tiny else torch.float32
    g = torch.Generator(device=dev).manual_seed(18)
    if on_card:
        check_library_kernels(rows, g)
    out, ms = {}, {}
    h, w = (64, 96) if tiny else LIB_CANVAS
    base = (tiny_detector_config() if tiny else VINVL_X152C4).backbone
    fpn_ch = 16 if tiny else FPN_CHANNELS
    n_rois, n_masks = (40, 8) if tiny else (LIB_ROIS, LIB_MASKS)

    def timed(name: str, fn):
        """``fn()`` on the main path: counts zeroed just before, read just
        after, host ms with the card synchronised."""
        zero_counts(counters)
        t = time.perf_counter()
        with torch.no_grad():
            r = fn()
        if on_card:
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t) * 1e3
        ran = {k: c.launches for k, c in counters.items()}
        want = {k: LIB_LAUNCHES[name].get(k, 0) for k in counters}
        check(ran == want, f"{name} launches {ran}, want {want}")
        out.setdefault("launches_by_path", {})[name] = ran
        return r

    # --- ResNetFPN: the pyramid P2..P6, each level finite, the widths
    with torch.device(dev):
        fpn = ResNetFPN(dc.replace(base, stage_blocks=FPN_STAGE_BLOCKS),
                        fpn_ch, dt)
    random_module_weights(fpn, 18)
    fpn.eval()
    image = (torch.rand(1, h, w, 3, generator=g, device=dev) * 255 - 128).to(dt)
    timed("fpn", lambda: fpn(image))                  # warm-up (cuDNN plans)
    pyramid = timed("fpn", lambda: fpn(image))
    shapes = [tuple(p.shape) for p in pyramid]
    want_hw = [(-(-h // s), -(-w // s)) for s in FPN_STRIDES]
    check(shapes == [(1, a, b, fpn_ch) for a, b in want_hw]
          and all(bool(torch.isfinite(p).all()) for p in pyramid),
          f"ResNetFPN pyramid {shapes}")
    del fpn

    # --- multi-level pooling (K2 on every level), then the FPN mask head
    # on 100 RoIs, their masks pasted onto the canvas and scored by the
    # Cityscapes evaluator, and the keypoint head
    rois = torch.from_numpy(library_rois(n_rois) * np.float32(h / LIB_CANVAS[0])
                            ).to(dev)
    levels = [p[0] for p in pyramid[:4]]
    pooled = timed("pool", lambda: multilevel_roi_align(levels, rois,
                                                        scales=FPN_SCALES))
    check(tuple(pooled.shape) == (n_rois, 7, 7, fpn_ch)
          and bool(torch.isfinite(pooled).all()), f"pooled {pooled.shape}")
    with torch.device(dev):
        mask_head = eh.MaskHead(fpn_ch, LIB_CLASSES, (fpn_ch,) * 4, fpn_ch, dt)
        kp_head = eh.KeypointHead(fpn_ch, LIB_KEYPOINTS,
                                  (64,) * 2 if tiny else (512,) * 8, dt)
    random_module_weights(mask_head, 181)
    random_module_weights(kp_head, 182)
    labels = torch.randint(1, LIB_CLASSES + 1, (n_masks,), generator=g,
                           device=dev)
    boxes = rois[1:n_masks + 1]

    def heads():
        logits = mask_head(pooled[1:n_masks + 1])
        probs = eh.select_class_masks(logits, labels)
        pasted = eh.paste_masks(probs, boxes, h, w)
        heat = kp_head(pooled[1:n_masks + 1])
        xy, score = eh.heatmaps_to_keypoints(heat, boxes)
        return logits, probs, pasted, heat, xy, score

    logits, probs, pasted, heat, kxy, kscore = timed("heads", heads)
    check(tuple(logits.shape) == (n_masks, 14, 14, LIB_CLASSES)
          and tuple(pasted.shape) == (n_masks, h, w)
          and tuple(heat.shape) == (n_masks, 28, 28, LIB_KEYPOINTS)
          and all(bool(torch.isfinite(t.float()).all())
                  for t in (logits, probs, heat, kxy, kscore)),
          f"mask / keypoint heads {logits.shape} {pasted.shape} {heat.shape}")
    b_np = boxes.cpu().numpy()
    m_np = pasted.cpu().numpy()
    check(bool(m_np.any()), "no pasted mask has a pixel")
    n_cls = 8
    scores_np = np.linspace(0.95, 0.3, n_masks)
    t = time.perf_counter()
    city = cityscapes_instance_eval(
        [{"boxes": b_np[:20], "labels": labels[:20].cpu().numpy() % n_cls,
          "masks": m_np[:20]}],
        [{"boxes": b_np, "labels": labels.cpu().numpy() % n_cls,
          "masks": m_np, "scores": scores_np}],
        [f"class{i}" for i in range(n_cls)])
    ms["cityscapes_eval"] = (time.perf_counter() - t) * 1e3
    city_ap = {k: city[k]["averages"]["allAp"] for k in city}
    check(all(np.isfinite(v) and v > 0 for v in city_ap.values()),
          f"cityscapes AP {city_ap}")
    out["masks"] = {"pixels": int(m_np.sum()), "cityscapes_ap": city_ap}
    del pasted, m_np, heat, mask_head, kp_head

    # --- RetinaNet on the five levels, then its merge on K5
    with torch.device(dev):
        retina = eh.RetinaNetHead(LIB_CLASSES, 9, 4, fpn_ch, dt)
    random_module_weights(retina, 183)
    per_level = [torch.from_numpy(eh.retinanet_grid_anchors([s], [st])).to(dev)
                 for s, st in zip(want_hw, FPN_STRIDES)]
    merges = []
    real_nms = eh.nms_pallas

    def nms(*a):
        r = real_nms(*a)
        merges.append(a + r)
        return r

    def retina_path():
        cls_logits, deltas = retina(pyramid)
        return eh.retinanet_select(cls_logits, deltas, per_level,
                                   num_classes=LIB_CLASSES, image_size=(h, w),
                                   pre_nms_top_n=RETINA_TOP_N,
                                   nms_thresh=RETINA_NMS_THR,
                                   max_det=RETINA_MAX_DET)

    eh.nms_pallas = nms
    try:
        rboxes, rscores, rlabels, rkeep = timed("retina", retina_path)
    finally:
        eh.nms_pallas = real_nms
    from cpt_tpu_torch.ops.nms import nms_padded

    bx, sc, va, thr, max_out, idx, keep = merges[0]
    want_idx, want_keep = nms_padded(bx, sc, va, thr, max_out)
    exact = bool(torch.equal(keep, want_keep)
                 and torch.equal(idx[keep], want_idx[want_keep]))
    check(len(merges) == 1 and exact and int(bx.shape[0]) == sum(
        min(RETINA_TOP_N, a * b * 9 * LIB_CLASSES) for a, b in want_hw)
          and bool(torch.isfinite(rboxes).all()) and int(rkeep.sum()) > 0,
          f"RetinaNet merge: K {bx.shape[0]}, equal to nms_padded {exact}, "
          f"kept {int(rkeep.sum())}")
    out["retina"] = {"k": int(bx.shape[0]), "kept": int(rkeep.sum()),
                     "valid": int(va.sum()), "exact": exact,
                     "max_coord": float(bx.max())}
    del retina, pyramid, levels, pooled

    # --- MsViT at the JAX default arch (window 7), FBNet's default trunk,
    # DFConv2d (DCN v2) at a stage-3 shape
    with torch.device(dev):
        vit = MsViT(window=7, dtype=dt)
        fbn = FBNetTrunk(dtype=dt)
        c3 = 32 if tiny else 1024
        dcn = DFConv2d(c3, c3, dtype=dt)
    for i, m in enumerate((vit, fbn, dcn)):
        random_module_weights(m, 184 + i)
    x3 = torch.randn(1, h // 16, w // 16, c3, generator=g, device=dev).to(dt)

    def other_modules():
        return vit(image), fbn(image), dcn(x3)

    vit_out, fb_out, dcn_out = timed("other_modules", other_modules)
    check([tuple(v.shape) for v in vit_out] == [(1, h // 4, w // 4, 96),
                                                (1, h // 8, w // 8, 192)]
          and tuple(fb_out.shape) == (1, h // 16, w // 16, 96)
          and tuple(dcn_out.shape) == (1, h // 16, w // 16, c3)
          and all(bool(torch.isfinite(v.float()).all())
                  for v in list(vit_out) + [fb_out, dcn_out]),
          f"MsViT {[v.shape for v in vit_out]}, FBNet {fb_out.shape}, "
          f"DFConv2d {dcn_out.shape}")
    for name, m, args in (("msvit", vit, (image,)), ("fbnet", fbn, (image,)),
                          ("dfconv", dcn, (x3,))):
        zero_counts(counters)
        t = time.perf_counter()
        with torch.no_grad():
            m(*args)
        if on_card:
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t) * 1e3
    del vit, fbn, dcn
    if on_card:
        torch.cuda.empty_cache()
    out["launches"] = {k: sum(r[k] for r in out["launches_by_path"].values())
                       for k in counters}
    out["ms"] = ms
    phase_s = time.perf_counter() - t_phase
    print(f"phase 18 library modules ({smi}): ResNetFPN X152 "
          f"{FPN_STAGE_BLOCKS} pyramid {shapes}; host ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + "; launches " + ", ".join(
              f"{p} {({k: v for k, v in r.items() if v})}"
              for p, r in out["launches_by_path"].items())
          + f"; masks "
          f"{out['masks']}; RetinaNet merge {out['retina']}; in "
          f"{phase_s:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 18: {failed}")
    out["seconds"] = phase_s
    return out


# Phase 19: two processes of ``extract_features --shard_by_process`` on the
# one card, a gloo group over localhost, at full X152 width: the first
# section of the two rank processes that phase 20 goes on with
# (``RankProcesses``, ``shard_section``).
SHARD_QUERIES = 4


class RankProcesses:
    """Phases 19-20's two rank processes of one gloo group on the card
    (``MESH_WORKER``, each under ``timeout``), started before phase 10:
    each draws its random weights on the host, waits for :meth:`go` (phase
    19), then prints one JSON line after phase 19's section and one at its
    end; :meth:`record` reads a rank's next line, :meth:`finish` waits for
    both and raises on a failed one; :meth:`close` stops what is left (a
    rank whose stdin closes before :meth:`go` ends)."""

    def __init__(self, root: str):
        from cpt_tpu_torch.parallel.distributed import free_port

        repo = os.path.dirname(os.path.abspath(__file__))
        worker = os.path.join(root, "worker.py")
        with open(worker, "w") as f:
            f.write(MESH_WORKER.format(repo=repo, root=root))
        env = dict(os.environ, PYTHONPATH=repo,
                   CPT_COORDINATOR=f"127.0.0.1:{free_port()}",
                   CPT_NUM_PROCESSES="2")
        self.errs = [os.path.join(root, f"rank{i}.err") for i in range(2)]
        self.procs = []
        for i in range(2):
            with open(self.errs[i], "w") as err:
                self.procs.append(subprocess.Popen(
                    ["timeout", "-k", "10", str(MESH_TIMEOUT_S), sys.executable,
                     worker], cwd=root, env=dict(env, CPT_PROCESS_ID=str(i)),
                    text=True, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=err))

    def go(self) -> None:
        for p in self.procs:
            p.stdin.write("go\n")
            p.stdin.close()

    def _fail(self, i: int, what: str):
        self.procs[i].wait()
        with open(self.errs[i]) as f:
            raise AssertionError(f"rank {i} {what} (exit "
                                 f"{self.procs[i].returncode}): {f.read()[-3000:]}")

    def record(self, i: int) -> dict:
        for line in self.procs[i].stdout:
            if line.startswith("{"):
                return json.loads(line)
        self._fail(i, "ended before its record")

    def finish(self) -> list:
        out = [self.record(i) for i in range(2)]
        for i, p in enumerate(self.procs):
            if p.wait(timeout=MESH_TIMEOUT_S + 30) != 0:
                self._fail(i, "failed")
        return sorted(out, key=lambda r: r["pid"])

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def shard_section(counters) -> dict:
    """Phase 19's section of a rank: ``extract_features --synthetic 4
    --shard_by_process`` into ``pred.shard<i>.tsv``, ``allreduce_sum`` of
    the copies, ``sync``, the shards merged by rank 0 into ``merged.tsv``."""
    import torch

    from cpt_tpu_torch.parallel import distributed as D
    from cpt_tpu_torch.tools import extract_features, merge_shards

    zero_counts(counters)
    info = extract_features.main(["--synthetic", str(SHARD_QUERIES),
                                  "--copies_per_chunk", "4", "--shard_by_process",
                                  "--output", "pred.tsv"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    total = D.allreduce_sum(float(info["copies"]), 1.0)
    D.sync("extracted")
    if D.is_main_process():
        merge_shards.main(["--shards", "pred.shard*.tsv", "--output", "merged.tsv"])
    D.sync("merged")
    return {"copies": info["copies"], "total": total, "launches": launches,
            "extract_s": info["seconds"]}


def run_process_runtime(counters, smi: str, ranks: RankProcesses,
                        root: str) -> dict:
    """Phase 19 (see the module docstring): the ranks' first records (their
    shard section), then one process's extraction of the same queries
    here; the merged shards must equal it byte for byte."""
    from cpt_tpu_torch.tools import extract_features

    t_phase = time.perf_counter()
    zero_counts(counters)
    single = extract_features.main(["--synthetic", str(SHARD_QUERIES),
                                    "--copies_per_chunk", "4", "--output",
                                    f"{root}/single.tsv"])
    single_launches = {k: c.launches for k, c in counters.items()}
    workers = sorted((ranks.record(i) for i in range(2)), key=lambda r: r["pid"])
    with open(f"{root}/merged.tsv") as f:
        merged = f.read()
    with open(f"{root}/single.tsv") as f:
        one = f.read()
    shard_rows = []
    for i in range(2):
        with open(f"{root}/pred.shard{i}.tsv") as f:
            shard_rows.append(f.read().count("\n"))
    identical = merged == one
    rows_m = [ln.split("\t") for ln in merged.splitlines()]
    rows_1 = [ln.split("\t") for ln in one.splitlines()]
    same_keys = [r[0] for r in rows_m] == [r[0] for r in rows_1]
    copies = sum(r["copies"] for r in workers)
    launches = {k: sum(r["launches"].get(k, 0) for r in workers) for k in counters}
    ok = (identical and [r["count"] for r in workers] == [2, 2]
          and all(r["total"] == [float(copies), 2.0] for r in workers)
          and copies == single["copies"] and launches["K1"] > 0
          and launches["K2"] > 0 and shard_rows == [SHARD_QUERIES // 2] * 2)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 19 process runtime ({smi}): 2 gloo processes on one card "
          f"(devices {[r['device'] for r in workers]}), "
          f"extract_features --synthetic {SHARD_QUERIES} --shard_by_process: "
          f"shards of {shard_rows} rows, {copies} copies (allreduce_sum "
          f"{workers[0]['total']}), worker seconds "
          f"{[round(r['seconds'], 1) for r in workers]} (extraction "
          f"{[round(r['extract_s'], 2) for r in workers]}), launches {launches}; "
          f"merged shards equal one process's TSV byte for byte: {identical} "
          f"(keys equal {same_keys}; one process: launches {single_launches}, "
          f"extracted meanwhile); in {phase_s:.1f} s", flush=True)
    if not ok:
        raise AssertionError(f"phase 19: workers {workers}, identical "
                             f"{identical}, shard rows {shard_rows}")
    return {"workers": workers, "identical": identical, "shard_rows": shard_rows,
            "launches": launches, "single_launches": single_launches,
            "single_tsv": one, "seconds": phase_s}


# Phase 20: the device meshes and the pipeline (``parallel/mesh.py``,
# ``parallel/pipeline.py``): phase 19's two rank processes go on, one rank
# each (``MESH_WORKER`` → ``mesh_rank``), at full width. The ranks start
# before phase 10 and wait for phase 19: their limit covers phases 10-20.
MESH_TIMEOUT_S = 600
MESH_WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import chip_smoke
chip_smoke.mesh_rank({root!r})
"""
# (b): the RefCOCO fixture and prompt tuning of ``refcoco_cpt --dp 2``
MESH_QUERIES, MESH_COPIES = 8, 4
MESH_TRAIN_BATCH, MESH_EVAL_BATCH = 8, 16
# (c): pp 2, 2 micro-batches over the grounding batch [16, 70 + 50]
MESH_PP, MESH_MICRO, MESH_SCORE_BATCH = 2, 2, 16
MESH_PP_FAULTS = ("stages_swapped", "not_broadcast")
# (b) and (d) hold bf16 over dp 2 against bf16 in one process, so their
# limits come from those readings (H100 80GB HBM3, 700 W, three whole runs
# reading the same): (b)'s losses 2.456e-3 nats apart and its first
# update's gradients 8.272e-3 apart (largest per-tensor ‖Δg‖ / ‖g‖), (d)'s
# gradients 2.0e-3-3.5e-3 apart (largest per-leaf max |Δg| / max |g|).
# Each limit is 3-4x its reading; a gradient summed over the ranks reads
# 1.0 in both.
MESH_LOSS_TOL = 1e-2
MESH_GRAD_TOL = 2.5e-2
MESH_DET_GRAD_TOL = 1.5e-2
# (b) and (d)'s named faults: the averaged gradient summed over the ranks
# (× dp); and ``dp_mean`` handing each rank its own tensors back (no
# all-reduce, so each rank steps on its own share of the batch), planted
# in a run of its own (``no_all_reduce``)
MESH_DP_FAULTS = ("summed", "no_all_reduce")
# the per-rank launch shapes phase 20 gives the kernels: K1 and K2 on half
# of phase 19's chunk of 4 copies (640×1024), K3 on a micro-batch [8, 120]
# and on a rank's half of a training batch [4, 120], K4 on its 480 rows
K1_MESH_SHAPES = [(2, 160, 256, 256, 1), (2, 80, 128, 512, 1),
                  (2, 40, 64, 1024, 1)]


def _grad_norm_gaps(got: dict, want: dict) -> dict:
    """Per tensor ‖got − want‖ / ‖want‖ (tensors with a nonzero want)."""
    return {n: float((got[n] - want[n]).norm() / want[n].norm())
            for n in want if float(want[n].norm()) > 0}


def first_divergent_module(model, args: tuple) -> dict:
    """Run ``model.forward_batch_force`` on the 2 copies of ``args`` and on
    them twice over (4 copies), each module's output of the first run
    against the matching rows of the second's, in call order → the first
    module whose rows differ (None: none), how many were compared and
    whether the pooled features agree."""
    import torch

    x, rest = args[0], args[1:]
    half, order = {}, []

    def keep(name):
        def hook(_m, _i, out):
            out = out[0] if isinstance(out, (tuple, list)) else out
            if torch.is_tensor(out) and out.dim() and out.shape[0] % 2 == 0:
                half[name] = out[:out.shape[0] // 2].clone()
        return hook

    def check(name):
        def hook(_m, _i, out):
            out = out[0] if isinstance(out, (tuple, list)) else out
            want = half.pop(name, None)
            if want is not None and torch.is_tensor(out) and out.shape == want.shape:
                order.append((name, bool(torch.equal(out, want))))
        return hook

    mods = [(n, m) for n, m in model.named_modules() if n]
    with torch.inference_mode():
        hooks = [m.register_forward_hook(keep(n)) for n, m in mods]
        try:
            four = model.forward_batch_force(torch.cat([x, x]), *rest)
        finally:
            for h in hooks:
                h.remove()
        hooks = [m.register_forward_hook(check(n)) for n, m in mods]
        try:
            two = model.forward_batch_force(x, *rest)
        finally:
            for h in hooks:
                h.remove()
    k = two["box_features"].shape[0]
    first = next((n for n, same in order if not same), None)
    return {"first_divergent": first, "compared": len(order),
            "features_equal": bool(torch.equal(four["box_features"][:k],
                                               two["box_features"]))}


@contextlib.contextmanager
def no_all_reduce():
    """The named fault ``no_all_reduce``: ``parallel/mesh.dp_mean`` returns
    each rank's own tensors, as DDP without its all-reduce would."""
    from cpt_tpu_torch.parallel import mesh as meshlib

    real = meshlib.dp_mean
    meshlib.dp_mean = lambda tensors, mesh: list(tensors)
    try:
        yield
    finally:
        meshlib.dp_mean = real


def mesh_extract(counters, root: str) -> dict:
    """(a) ``extract_features --synthetic 4 --copies_per_chunk 4 --dp 2``:
    each rank extracts 2 of every chunk's 4 copies, rank 0 writes
    ``dp.tsv``; then rank 0 holds a chunk of 2 copies against the same 2
    copies inside a chunk of 4, module by module."""
    import torch

    from cpt_tpu_torch.models.detector.attr_rcnn import AttrRCNN
    from cpt_tpu_torch.parallel import distributed as D
    from cpt_tpu_torch.tools import extract_features as ef

    built, first = [], []
    real_build, real_force = ef.build_detector, AttrRCNN.forward_batch_force

    def force(self, *a, **kw):
        if not first:
            first.append(a)
        return real_force(self, *a, **kw)

    ef.build_detector = lambda cfg, args: built.append(real_build(cfg, args)) or built[-1]
    AttrRCNN.forward_batch_force = force
    zero_counts(counters)
    try:
        info = ef.main(["--synthetic", str(SHARD_QUERIES), "--copies_per_chunk",
                        "4", "--dp", "2", "--output", f"{root}/dp.tsv"])
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        ef.build_detector, AttrRCNN.forward_batch_force = real_build, real_force
    out = {"copies": info["copies"], "launches": launches,
           "k1_paths": k1_paths(counters, launches, "phase 20 (a)"),
           "extract_s": info["seconds"]}
    if D.is_main_process():
        out["divergence"] = first_divergent_module(built[-1], first[0])
    del built, first
    torch.cuda.empty_cache()
    return out


def mesh_refcoco(counters, root: str) -> dict:
    """(b) ``refcoco_cpt --dp 2`` at Oscar-base on
    ``data/synthetic.generate_refcoco_fixture`` (dropout off): 2 prompt-
    tuning steps of batch 8 (4 a rank), eval batches of 16 split over the
    ranks; then on rank 0 the same 2 steps over the same mesh under
    ``no_all_reduce`` and in one process. The losses and the first
    update's gradients (what the optimizer is handed) against one
    process's, and the faults' gradients."""
    import torch

    from cpt_tpu_torch.data.refcoco import iter_train_batches
    from cpt_tpu_torch.data.synthetic import generate_refcoco_fixture
    from cpt_tpu_torch.engine import train as train_lib
    from cpt_tpu_torch.parallel import distributed as D
    from cpt_tpu_torch.parallel.mesh import make_mesh
    from cpt_tpu_torch.tools import refcoco_cpt

    dev = torch.device("cuda", torch.cuda.current_device())
    paths = generate_refcoco_fixture(f"{root}/refcoco{D.process_index()}",
                                     n_queries=MESH_QUERIES,
                                     n_copies=MESH_COPIES, feat_dim=2054)
    argv = ["--data_file", paths["data_file"], "--ann_file", paths["ann_file"],
            "--det_file", paths["det_file"], "--train_data_file",
            paths["data_file"], "--num_train_epochs", "1",
            "--per_gpu_train_batch_size", str(MESH_TRAIN_BATCH),
            "--per_gpu_eval_batch_size", str(MESH_EVAL_BATCH), "--seed", "0"]
    real_step, real_train, real_load, real_tx = (
        train_lib.make_mlm_train_step, refcoco_cpt.train, refcoco_cpt.load_model,
        train_lib.build_optimizer)
    losses, calls, first_grads = [], [], []

    def build_optimizer(model, cfg, *a, **kw):
        # the tool's optimizer, recording the gradients of its first update
        tx = real_tx(model, cfg, *a, **kw)
        update = tx.update
        names = [n for n, _ in model.named_parameters()]

        def record(grads, st, params):
            if not mine:
                mine.update({n: g.float().clone() for n, g in
                             zip(names, grads) if g is not None})
            return update(grads, st, params)

        mine = {}
        tx.update = record
        first_grads.append(mine)
        return tx

    train_lib.make_mlm_train_step = functools.partial(real_step, dropout=False)
    train_lib.build_optimizer = build_optimizer
    refcoco_cpt.train = lambda *a, **kw: (calls.append((a, kw))
                                          or losses.extend(real_train(*a, **kw)))
    zero_counts(counters)
    try:
        t0 = time.perf_counter()
        acc = refcoco_cpt.main(argv + ["--dp", "2"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        out = {"acc": acc, "losses": losses, "launches": launches,
               "run_s": run_s}
        if D.is_main_process():
            (_, train_data, args, _), kw = calls[-1]
            cfg = refcoco_cpt.model_config(args)
            with no_all_reduce():   # no collective left: rank 0 runs alone
                real_train(real_load(cfg, args, dev, torch.bfloat16).eval(),
                           train_data, args, dev, mesh=kw["mesh"])
            one = real_load(cfg, args, dev, torch.bfloat16).eval()
            t0 = time.perf_counter()
            one_losses = real_train(one, train_data, args, dev)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            dp_grads, skipped, one_grads = first_grads[-3:]
            gaps = _grad_norm_gaps(dp_grads, one_grads)
            faults = {
                "summed": _grad_norm_gaps({n: 2 * g for n, g in dp_grads.items()},
                                          one_grads),
                "no_all_reduce": _grad_norm_gaps(skipped, one_grads)}
            out.update({"one_losses": one_losses, "one_s": one_s,
                        "grad_gap": max(gaps.values()),
                        "grad_gap_at": max(gaps, key=gaps.get),
                        "fault_gaps": {f: [min(g.values()), max(g.values())]
                                       for f, g in faults.items()}})
    finally:
        train_lib.make_mlm_train_step, train_lib.build_optimizer = real_step, real_tx
        refcoco_cpt.train = real_train
    del calls, first_grads
    torch.cuda.empty_cache()
    return out


def mesh_pipeline(counters) -> dict:
    """(c) pipelined scoring at Oscar-base (12 layers, bf16, random weights
    from seed 0): pp 2 × n_micro 2 over the grounding batch [16, 70 + 50]
    (K3 and K4 6 × 2 a rank), against the same model's sequential scoring
    on this rank, with MESH_PP_FAULTS."""
    import torch

    from cpt_tpu_torch.config.bert import OSCAR_BASE
    from cpt_tpu_torch.models.bert.heads import REC_MLM_CPT
    from cpt_tpu_torch.parallel import mesh as meshlib
    from cpt_tpu_torch.parallel import pipeline
    from cpt_tpu_torch.utils import convert as cv

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = OSCAR_BASE
    with torch.device(dev):
        model = REC_MLM_CPT(cfg, torch.bfloat16).eval()
    model.load_state_dict(cv.state_from_reference(
        cv.random_oscar_state_dict(cfg, seed=0), cfg))
    rng = np.random.RandomState(20)
    b, txt, img = MESH_SCORE_BATCH, 70, 50
    ids = rng.randint(1000, cfg.vocab_size, (b, txt))
    ids[:, 5] = 103
    mask = np.ones((b, txt + img), np.int64)
    mask[b // 2:, 40:txt] = 0
    arrays = [torch.from_numpy(a).to(dev) for a in (
        ids, np.zeros((b, txt), np.int64), mask,
        rng.randn(b, img, cfg.img_feature_dim).astype(np.float32),
        np.full((b,), 5, np.int64))]
    mesh = pipeline.make_pp_mesh(1, MESH_PP)
    stage = pipeline.pipelined_stage(model, mesh)
    s = meshlib.axis_index(mesh, "pp")
    stacked = pipeline.stack_layer_params(model.bert.encoder,
                                          cfg.num_hidden_layers)
    k = cfg.num_hidden_layers // MESH_PP
    other = {n: t[(1 - s) * k:(2 - s) * k] for n, t in stacked.items()}
    fn = pipeline.make_pp_scoring_fn(cfg, mesh, MESH_MICRO, torch.bfloat16)
    with torch.inference_mode():
        want = model(*arrays[:3], img_feats=arrays[3], mask_pos=arrays[4])[1].float()
        fn(model, stage, *arrays)     # warm-up
        torch.cuda.synchronize()
        zero_counts(counters)
        t0 = time.perf_counter()
        got = fn(model, stage, *arrays)
        torch.cuda.synchronize()
        pp_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        model(*arrays[:3], img_feats=arrays[3], mask_pos=arrays[4])
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
        faults = {"stages_swapped": float((fn(model, other, *arrays) - want)
                                          .abs().max())}
        real_bc = meshlib.broadcast
        meshlib.broadcast = lambda x, src, group: x
        try:
            faults["not_broadcast"] = float((fn(model, stage, *arrays) - want)
                                            .abs().max())
        finally:
            meshlib.broadcast = real_bc
    out = {"stage": s, "gap": float((got - want).abs().max()),
           "scale": float(want.abs().max()), "shape": list(got.shape),
           "finite": bool(torch.isfinite(got).all()), "fault_gaps": faults,
           "launches": launches, "pp_ms": pp_ms, "seq_ms": seq_ms}
    del model, stage, stacked, other
    torch.cuda.empty_cache()
    return out


def mesh_detector(counters) -> dict:
    """(d) one sharded detector step at full width (X152-C4, phase 16's
    seed-0 trainable weights, bf16, the 1024×1024 canvas): 2 synthetic
    images of ``train_detector``'s stream, one a rank; then on rank 0 its
    image's step over the same mesh under ``no_all_reduce`` and the
    one-process batched step on both. Each step's loss dict and its
    averaged gradients of DET_GRAD_LEAVES (what the optimizer is handed)."""
    import itertools

    import torch

    from cpt_tpu_torch.engine import detector_train as dt
    from cpt_tpu_torch.parallel import distributed as D
    from cpt_tpu_torch.parallel.mesh import make_mesh
    from cpt_tpu_torch.tools import train_detector as td

    dev = torch.device("cuda", torch.cuda.current_device())
    args = td.build_args().parse_args(["--synthetic", "2", "--device", "cuda",
                                       "--dtype", "bfloat16"])
    cfg = td.VINVL_X152C4
    anchors = torch.from_numpy(td.grid_anchors(cfg.rpn, cfg.input.pad_h // 16,
                                               cfg.input.pad_w // 16)).to(dev)
    two = list(itertools.islice(td.batches(args, cfg, dev, anchors), 2))
    batch = [torch.stack([a, b]) for a, b in zip(two[0][:6], two[1][:6])]
    batch.append(anchors)
    real_random = td.dconv.random_vinvl_state_dict
    td.dconv.random_vinvl_state_dict = (
        lambda c, seed=0: trainable_weights(real_random(c, seed)))

    def step(mesh):
        model = td.build_trainer(args, cfg, dev)
        names, leaves = dt.detector_leaves(model)
        tx = dt.build_detector_optimizer([dt.jax_path(n) for n in names],
                                         dt.SolverConfig())
        grads = {}
        tx.update = lambda gs, st, ps: grads.update(
            {n: g.float().clone() for n, g in zip(names, gs)
             if n in DET_GRAD_LEAVES and g is not None})
        st = dt.TrainState(params=leaves, opt_state=tx.init(leaves))
        fn = dt.make_detector_train_step_batched(model, tx,
                                                 dt.freeze_mask(names), mesh)
        zero_counts(counters)
        t0 = time.perf_counter()
        _, total, losses = fn(st, batch, torch.Generator(device=dev).manual_seed(20))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ran = {k: c.launches for k, c in counters.items()}
        del model, st, fn
        return (float(total), {k: float(v) for k, v in losses.items()}, grads,
                ran, ms)

    try:
        mesh = make_mesh(dp=2)
        total, losses, grads, launches, ms = step(mesh)
        out = {"total": total, "losses": losses, "launches": launches,
               "step_ms": ms, "finite": bool(np.isfinite(total))}
        if D.is_main_process():
            with no_all_reduce():   # no collective left: rank 0 runs alone
                skipped = step(mesh)[2]
            one_total, one_losses, one_grads, _, one_ms = step(None)

            def gaps(gr):
                return {n: float((gr[n] - one_grads[n]).abs().max()
                                 / one_grads[n].abs().max()) for n in one_grads}

            faults = {"summed": gaps({n: 2 * g for n, g in grads.items()}),
                      "no_all_reduce": gaps(skipped)}
            out.update({"one_total": one_total, "one_losses": one_losses,
                        "one_step_ms": one_ms, "grad_gaps": gaps(grads),
                        "fault_gaps": {f: [min(g.values()), max(g.values())]
                                       for f, g in faults.items()}})
    finally:
        td.dconv.random_vinvl_state_dict = real_random
    torch.cuda.empty_cache()
    return out


def mesh_dryrun(counters) -> dict:
    """(e) ``tools/dryrun_multichip``'s rank body on this world of 2: a dp
    1 × tp 2 FSDP mesh (two accumulated steps), extraction over dp, pp 2
    scoring with its gradients."""
    import torch

    from cpt_tpu_torch.tools import dryrun_multichip

    zero_counts(counters)
    t0 = time.perf_counter()
    line = dryrun_multichip.run(dryrun_multichip.build_args().parse_args(["2"]))
    torch.cuda.synchronize()
    return {"line": line, "launches": {k: c.launches for k, c in counters.items()},
            "seconds": time.perf_counter() - t0}


def mesh_rank(root: str) -> None:
    """One rank of phases 19-20 (``MESH_WORKER``): its random weights
    drawn (``predraw_weights(ranks=True)``) while ``main`` runs phases
    10-18; on ``main``'s word (a line on stdin) phase 19's section, its
    record printed as a JSON line, then phase 20's sections (a)-(e) in
    turn, each with its kernel counts zeroed just before and read just
    after, and their record."""
    import torch

    from cpt_tpu_torch.parallel import distributed as D

    with cached_random_weights():
        predraw_weights(ranks=True)
        if sys.stdin.readline() != "go\n":
            return
        t0 = time.perf_counter()
        assert D.initialize_from_env()
        counters = kernel_counters()
        rank = {"pid": D.process_index(), "count": D.process_count(),
                "device": torch.cuda.current_device()}
        shard = shard_section(counters)
        print(json.dumps(dict(rank, seconds=time.perf_counter() - t0, **shard)),
              flush=True)
        t0 = time.perf_counter()
        out = dict(rank)
        out["extract"] = mesh_extract(counters, root)
        out["refcoco"] = mesh_refcoco(counters, root)
        out["pipeline"] = mesh_pipeline(counters)
        out["detector"] = mesh_detector(counters)
        out["dryrun"] = mesh_dryrun(counters)
    D.sync("phase 20")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def tsv_feature_gap(got: str, want: str) -> tuple:
    """Two extraction TSVs' texts → (keys and boxes equal, max |Δ feature| /
    max |feature|)."""
    def rows(text):
        return [ln.split("\t") for ln in text.splitlines()]

    same, gap, scale = True, 0.0, 0.0
    g_rows, w_rows = rows(got), rows(want)
    same &= [r[0] for r in g_rows] == [r[0] for r in w_rows]
    for g, w in zip(g_rows, w_rows):
        go, wo = json.loads(g[1])["objects"][0], json.loads(w[1])["objects"][0]
        for gc, wc in zip(go, wo):
            for gb, wb in zip(gc, wc):
                same &= gb["rect"] == wb["rect"]
                gf = np.frombuffer(base64.b64decode(gb["feature"]), np.float32)
                wf = np.frombuffer(base64.b64decode(wb["feature"]), np.float32)
                gap = max(gap, float(np.abs(gf - wf).max()))
                scale = max(scale, float(np.abs(wf).max()))
    return same, gap / max(scale, 1e-12)


def check_mesh_kernels(rows: list, g) -> None:
    """Phase 20's per-rank launch shapes (``K1_MESH_SHAPES``, K2 on 2
    copies, K3 at [8,120] and [4,120], K4 at 480 rows) against their plain
    versions and named faults, by device time."""
    import torch

    from cpt_tpu_torch.ops.roi_align_pallas import (batched_roi_align,
                                                    batched_roi_align_plain)

    check_k1(rows, K1_MESH_SHAPES, g, device=("grouped_conv3x3_mma",))
    _, _, rois = k2_shapes()[0]
    shape = (2, 40, 64, 1024)
    feats = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    rois_t = torch.from_numpy(rois).cuda()
    compare("K2", f"a rank's half chunk (dp 2): feats={list(shape)} "
            f"rois={len(rois)}",
            lambda: batched_roi_align(feats, rois_t, 1 / 16.0, 14, 0, 8),
            lambda: batched_roi_align_plain(feats, rois_t, 1 / 16.0, 14, 0, 8),
            lambda: batched_roi_align_plain(feats.float(), rois_t, 1 / 16.0,
                                            14, 0, 8), rows,
            k2_faults(feats, rois_t, 1 / 16.0, 14, 0, 8),
            work=k2_work(shape, rois, 1 / 16.0) + (F32_OPS_S,),
            device="roi_align")
    check_k3(rows, MESH_SCORE_BATCH // MESH_MICRO, 120)
    check_k3(rows, MESH_TRAIN_BATCH // 2, 120)
    check_k4(rows, MESH_TRAIN_BATCH // 2 * 120)


def run_mesh_phase(counters, smi: str, rows: list, single_tsv: str,
                   procs: RankProcesses, root: str) -> dict:
    """Phase 20 (see the module docstring): the ranks' last records, the
    checks here against phase 19's one-process TSV and each rank's own
    references, then the per-rank launch shapes' kernel rows. Gathers
    every reading, prints it, then raises on the first check that
    failed."""
    import torch

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    ranks = procs.finish()
    with open(f"{root}/dp.tsv") as f:
        dp_tsv = f.read()
    r0 = ranks[0]
    sections = ("extract", "refcoco", "pipeline", "detector", "dryrun")
    launches = {sec: {k: sum(r[sec]["launches"][k] for r in ranks)
                      for k in counters} for sec in sections}
    per_rank = {sec: [r[sec]["launches"] for r in ranks] for sec in sections}
    check([r["count"] for r in ranks] == [2, 2], "world of 2")

    # (a) extraction over dp against phase 19's one-process TSV
    identical = dp_tsv == single_tsv
    same_boxes, feat_gap = tsv_feature_gap(dp_tsv, single_tsv)
    ex = [r["extract"] for r in ranks]
    check(same_boxes and (identical or feat_gap <= WINDOW_TOL),
          f"(a) --dp 2 TSV against one process: identical {identical}, "
          f"keys/boxes {same_boxes}, feature gap {feat_gap} (tol {WINDOW_TOL})")
    check(all(e["copies"] == 4 * 3 for e in ex)
          and all(lr["K1"] > 0 and lr["K2"] > 0 for lr in per_rank["extract"]),
          f"(a) copies {[e['copies'] for e in ex]}, launches "
          f"{per_rank['extract']}")

    # (b) refcoco_cpt --dp 2
    rc = [r["refcoco"] for r in ranks]
    loss_gap = max(abs(a - b) for a, b in zip(rc[0]["losses"],
                                             rc[0]["one_losses"]))
    check(len(rc[0]["losses"]) == 2 == len(rc[0]["one_losses"])
          and rc[0]["losses"] == rc[1]["losses"] and loss_gap <= MESH_LOSS_TOL,
          f"(b) losses {[r['losses'] for r in rc]} against one process "
          f"{rc[0]['one_losses']} (gap {loss_gap}, tol {MESH_LOSS_TOL})")
    check(rc[0]["grad_gap"] <= MESH_GRAD_TOL,
          f"(b) gradient gap {rc[0]['grad_gap']} (at {rc[0]['grad_gap_at']}, "
          f"tol {MESH_GRAD_TOL})")
    check(all(rc[0]["fault_gaps"][f][1] > MESH_GRAD_TOL for f in MESH_DP_FAULTS),
          f"(b) a fault passes: {rc[0]['fault_gaps']} (min, max)")
    check(all(lr["K3"] > 0 and lr["K4"] > 0 for lr in per_rank["refcoco"]),
          f"(b) launches {per_rank['refcoco']}")

    # (c) pipelined scoring
    pl = [r["pipeline"] for r in ranks]
    want_pp = MESH_MICRO * 12 // MESH_PP
    # the same kernels on the same rows in the same order: bit for bit
    check(all(p["gap"] == 0.0 and p["finite"] for p in pl),
          f"(c) pipelined logits against sequential: gaps "
          f"{[p['gap'] for p in pl]} (bit-equal wanted)")
    check(all(max(p["fault_gaps"][f] for p in pl) > 0.0
              for f in MESH_PP_FAULTS),
          f"(c) a fault passes: {[p['fault_gaps'] for p in pl]}")
    check(all(lr["K3"] == lr["K4"] == want_pp for lr in per_rank["pipeline"]),
          f"(c) launches {per_rank['pipeline']} (K3 and K4 {want_pp} a rank)")

    # (d) the sharded detector step
    dt_ = [r["detector"] for r in ranks]
    det_loss_gap = max(abs(dt_[0]["losses"][k] - dt_[0]["one_losses"][k])
                       for k in dt_[0]["one_losses"])
    check(all(d["finite"] for d in dt_) and dt_[0]["losses"] == dt_[1]["losses"]
          and det_loss_gap <= DET_LOSS_TOL
          and max(dt_[0]["grad_gaps"].values()) <= MESH_DET_GRAD_TOL,
          f"(d) losses {dt_[0]['losses']} / one process {dt_[0]['one_losses']} "
          f"(gap {det_loss_gap}), gradient gaps {dt_[0]['grad_gaps']} (tol "
          f"{MESH_DET_GRAD_TOL})")
    check(all(dt_[0]["fault_gaps"][f][1] > MESH_DET_GRAD_TOL
              for f in MESH_DP_FAULTS),
          f"(d) a fault passes: {dt_[0]['fault_gaps']} (min, max)")
    check(all(lr["K1"] == DET_STEP_LAUNCHES["K1"] and lr["K2"] == DET_STEP_LAUNCHES["K2"]
              and lr["K5"] == DET_STEP_LAUNCHES["K5"] for lr in per_rank["detector"]),
          f"(d) launches {per_rank['detector']} (one image a rank: "
          f"{DET_STEP_LAUNCHES})")

    # (e) the dry run
    dr = [r["dryrun"] for r in ranks]
    check(all(d["line"].startswith("dryrun_multichip ok: mesh={'dp': 1, 'tp': 2}")
              and "pp ok" in d["line"] for d in dr)
          and all(lr["K1"] > 0 and lr["K2"] > 0 and lr["K3"] > 0 and lr["K4"] > 0
                  for lr in per_rank["dryrun"]),
          f"(e) {[d['line'] for d in dr]}, launches {per_rank['dryrun']}")

    g = torch.Generator(device="cuda").manual_seed(20)
    n_rows = len(rows)
    try:
        check_mesh_kernels(rows, g)
    except AssertionError as e:
        failed.append(f"per-rank kernel shapes: {e}")
    phase_s = time.perf_counter() - t_phase
    div = r0["extract"]["divergence"]
    print(f"phase 20 meshes and pipeline ({smi}): 2 gloo processes on one card "
          f"(devices {[r['device'] for r in ranks]}), rank seconds "
          f"{[round(r['seconds'], 1) for r in ranks]}; (a) extract_features "
          f"--synthetic {SHARD_QUERIES} --dp 2: {[e['copies'] for e in ex]} copies, "
          f"TSV equal to one process's byte for byte: {identical} (feature gap "
          f"{feat_gap:.3e}; a chunk of 2 copies against the same 2 in a chunk "
          f"of 4: {div}), extraction s {[round(e['extract_s'], 2) for e in ex]}, "
          f"launches a rank {per_rank['extract']}; (b) refcoco_cpt --dp 2: "
          f"losses {rc[0]['losses']} / one process {rc[0]['one_losses']} "
          f"(gap {loss_gap:.3e}), first update's gradient gap "
          f"{rc[0]['grad_gap']:.3e} at {rc[0]['grad_gap_at']}, faults (min, "
          f"max over tensors) {rc[0]['fault_gaps']}, acc "
          f"{[r['acc'] for r in rc]}, run s {[round(r['run_s'], 1) for r in rc]} "
          f"/ one process's training {rc[0]['one_s']:.1f}, "
          f"launches a rank {per_rank['refcoco']}; (c) pp {MESH_PP} × n_micro "
          f"{MESH_MICRO} [{MESH_SCORE_BATCH},120]: gaps {[p['gap'] for p in pl]} "
          f"(scale {pl[0]['scale']:.3f}), faults {[p['fault_gaps'] for p in pl]}, "
          f"host ms pp {[round(p['pp_ms'], 1) for p in pl]} / sequential "
          f"{[round(p['seq_ms'], 1) for p in pl]}, launches a rank "
          f"{per_rank['pipeline']}; (d) detector step dp 2: losses "
          f"{dt_[0]['losses']} / one process {dt_[0]['one_losses']}, gradient "
          f"gaps {dt_[0]['grad_gaps']}, faults {dt_[0]['fault_gaps']}, host "
          f"ms {[round(d['step_ms'], 1) for d in dt_]} / one process "
          f"{dt_[0]['one_step_ms']:.1f}, launches a rank {per_rank['detector']}; "
          f"(e) {dr[0]['line']} in {[round(d['seconds'], 1) for d in dr]} s, "
          f"launches a rank {per_rank['dryrun']}; kernel rows "
          f"{len(rows) - n_rows}; in {phase_s:.1f} s after phase 19", flush=True)
    if failed:
        raise AssertionError(f"phase 20: {failed}")
    return {"ranks": ranks, "identical": identical, "feature_gap": feat_gap,
            "launches": launches, "per_rank": per_rank, "seconds": phase_s}


# Phase 21: real image files through the tools (utils/image_codec).
IMAGE_FILE_DETS = 8              # cpt_predict --image's candidates
WEBP_IMAGE = "alpha_480x640_q75.webp"    # cpt_predict --image x.webp's
WEBP_UPLOAD = "alpha_480x640_q75.webp"   # phase 8's WEBP upload
TIFF_IMAGE = "ycbcr_jpeg_22_480x640.tif"  # cpt_predict --image x.tif's
TIFF_UPLOAD = "ycbcr_jpeg_22_480x640.tif"  # phase 8's TIFF upload
ARITH_IMAGE = "arith_progressive_q50_480x640.jpg"  # cpt_predict --image's
COCO_IMAGES = ((480, 640), (427, 640))   # convert_dataset coco's JPEGs
INFO_SIZES = {"a.jpg": (333, 517), "b.jpeg": (64, 48), "c.png": (97, 131)}
COLOR_STEP = 128                 # img_info --all_color_imgs: 2^3 probes


def coco_fixture(root: str) -> tuple:
    """A COCO instances json over COCO_IMAGES written as quality-95 JPEGs
    (two to four boxes each, classes "cat", "dog", "car") → (json path,
    image dir)."""
    from cpt_tpu_torch.utils.image_codec import write_image

    rng = np.random.RandomState(2036)
    img_dir = f"{root}/images"
    os.makedirs(img_dir)
    images, anns = [], []
    for i, (h, w) in enumerate(COCO_IMAGES):
        name = f"{i + 1:012d}.jpg"
        write_image(f"{img_dir}/{name}", codec_photo(20 + i, h, w), quality=95)
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        for _ in range(rng.randint(2, 5)):
            x, y = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
            bw, bh = rng.uniform(30, w * 0.35), rng.uniform(30, h * 0.35)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.randint(1, 4)),
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh), "iscrowd": 0})
    cats = [{"id": i + 1, "name": n} for i, n in enumerate(("cat", "dog", "car"))]
    path = f"{root}/instances.json"
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    return path, img_dir


def run_image_files(counters, smi: str, tiny: bool = False) -> dict:
    """Phase 21 (see the module docstring): the codec's digests, then
    ``cpt_predict``, ``convert_dataset`` + ``test_detector --tsv``,
    ``img_info`` and ``validate_checkpoints --dryrun`` on real JPEG and PNG
    files. ``tiny``: the tools at their tiny sizes on the CPU (a dry run of
    the code paths; the launch checks fail there). Gathers every reading,
    prints it, then raises on the first check that failed."""
    import hashlib

    from cpt_tpu_torch.tools import (convert_dataset, cpt_predict, img_info,
                                     test_detector, validate_checkpoints)
    from cpt_tpu_torch.utils import image_codec

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    def counts() -> dict:
        return {k: c.launches for k, c in counters.items()}

    t_phase = time.perf_counter()
    out = {"codec": check_codec_digests()}
    dev = "cpu" if tiny else "cuda"
    common = ["--device", dev, "--dtype", "float32" if tiny else "bfloat16"]
    with tempfile.TemporaryDirectory() as root, cached_random_weights():
        # cpt_predict --image x.jpg --out y.png at full width
        img, dets = serve_request(np.random.RandomState(2035), IMAGE_FILE_DETS)
        image_codec.write_image(f"{root}/x.jpg", img, quality=95)
        flags = ["--image", f"{root}/x.jpg", "--caption", SERVE_CAPTION,
                 "--dets", json.dumps(dets), "--out", f"{root}/y.png",
                 "--workdir", f"{root}/wd"] + common
        flags += (["--tiny", "--hidden_size", "64", "--num_hidden_layers", "2"]
                  if tiny else [])
        zero_counts(counters)
        t = time.perf_counter()
        pred = cpt_predict.main(flags)
        predict_s = time.perf_counter() - t
        ran = counts()
        drawn = cpt_predict.draw_box_outline(
            image_codec.read_image(f"{root}/x.jpg"), pred, (0, 255, 0))
        written = image_codec.read_image(f"{root}/y.png")
        want = {k: 0 for k in counters}
        want.update({"K1": 50, "K2": 1, "K3": 12, "K4": 12})
        out["predict_image"] = {"pred_box": pred, "seconds": predict_s,
                                "out_equal": bool(np.array_equal(written, drawn)),
                                "launches": ran}
        check(list(pred) in dets and out["predict_image"]["out_equal"],
              f"cpt_predict --image/--out: {out['predict_image']}")
        check(ran == want, f"cpt_predict --image launches {ran}, want {want}")
        print(f"cpt_predict --image x.jpg (600x800, quality 95) --out y.png: "
              f"box {pred} of {len(dets)} candidates in {predict_s:.2f} s "
              f"(set-up included); the PNG read back equal to the drawn "
              f"decode {out['predict_image']['out_equal']}; launches {ran}",
              flush=True)

        # cpt_predict --image <file> at full width on three committed
        # fixtures (the card's host has no writer of any): a lossy-with-alpha
        # WEBP (WEBP_IMAGE) --out w.png, a TIFF of YCbCr JPEG strips
        # (TIFF_IMAGE) --out t.tif (Pillow's layout, encode_tiff) and an
        # arithmetic-coded progressive JPEG (ARITH_IMAGE) --out a.png; each
        # decode Pillow's (CODEC_DIGESTS)
        for key, name, out_name, seed, what in (
                ("predict_webp", WEBP_IMAGE, "w.png", 2037, "lossy with alpha"),
                ("predict_tiff", TIFF_IMAGE, "t.tif", 2040, "YCbCr JPEG strips"),
                ("predict_arith", ARITH_IMAGE, "a.png", 2043,
                 "arithmetic-coded progressive JPEG")):
            path, out_path = str(CODEC_DIR / name), f"{root}/{out_name}"
            fimg = image_codec.read_image(path)
            fdets = serve_request(np.random.RandomState(seed), IMAGE_FILE_DETS,
                                  *fimg.shape[:2], 300)[1]
            fflags = ["--image", path, "--caption", SERVE_CAPTION, "--dets",
                      json.dumps(fdets), "--out", out_path, "--workdir",
                      f"{root}/{key}"] + common
            fflags += (["--tiny", "--hidden_size", "64", "--num_hidden_layers",
                        "2"] if tiny else [])
            zero_counts(counters)
            t = time.perf_counter()
            fpred = cpt_predict.main(fflags)
            fpredict_s = time.perf_counter() - t
            ran = counts()
            drawn = cpt_predict.draw_box_outline(fimg.copy(), fpred, (0, 255, 0))
            got = out[key] = {
                "pred_box": fpred, "seconds": fpredict_s,
                "decode_equal": hashlib.sha256(fimg.tobytes()).hexdigest()
                == CODEC_DIGESTS[f"{name}:RGB"],
                "out_equal": bool(np.array_equal(
                    image_codec.read_image(out_path), drawn)),
                "launches": ran}
            if out_name.endswith(".tif"):
                got["out_equal"] &= (Path(out_path).read_bytes()
                                     == image_codec.encode_tiff(drawn))
            check(list(fpred) in fdets and got["out_equal"] and got["decode_equal"],
                  f"cpt_predict --image {name}/--out: {got}")
            check(ran == want, f"cpt_predict --image {name} launches {ran}, "
                               f"want {want}")
            print(f"cpt_predict --image {name} ({fimg.shape[0]}x"
                  f"{fimg.shape[1]}, {what}; decode equal to Pillow's "
                  f"{got['decode_equal']}) --out {out_name}: box {fpred} of "
                  f"{len(fdets)} candidates in {fpredict_s:.2f} s (set-up "
                  f"included); the file read back equal to the drawn decode "
                  f"{got['out_equal']}; launches {ran}", flush=True)

        # convert_dataset coco over a directory of JPEGs, then
        # test_detector --tsv on its yaml
        ann, img_dir = coco_fixture(f"{root}/coco")
        yaml_path = convert_dataset.main(["coco", "--ann", ann, "--img_dir",
                                          img_dir, "--out", f"{root}/coco_tsv"])
        if tiny:
            cfg_flags = ["--tiny"]
        else:
            with open(f"{root}/vinvl_x152c4.yaml", "w") as f:
                f.write(VINVL_YAML)
            cfg_flags = ["--config_file", f"{root}/vinvl_x152c4.yaml",
                         "--opts", *DETECTOR_OPTS]
        zero_counts(counters)
        t = time.perf_counter()
        results, _ = test_detector.main(cfg_flags + common + [
            "--tsv", yaml_path, "--coco_eval"])
        coco_s = time.perf_counter() - t
        ran = counts()
        metrics = {m: results[m] for m in ("mAP", "coco_AP", "coco_AP50")}
        out["coco_tsv"] = {"metrics": metrics, "seconds": coco_s,
                           "launches": ran}
        check(all(np.isfinite(v) for v in metrics.values()),
              f"test_detector --tsv metrics {metrics}")
        check(ran["K1"] > 0 and ran["K2"] > 0 and ran["K5"] > 0,
              f"test_detector --tsv launches {ran}")
        print(f"convert_dataset coco ({len(COCO_IMAGES)} JPEGs) -> "
              f"test_detector --tsv: {metrics} in {coco_s:.2f} s (set-up "
              f"included); launches {ran}", flush=True)

        # img_info over .jpg, .jpeg and .png files, and its colour probes
        info_dir = f"{root}/info"
        os.makedirs(info_dir)
        for name, (h, w) in INFO_SIZES.items():
            image_codec.write_image(f"{info_dir}/{name}",
                                    codec_photo(30, h, w))
        infos = img_info.main(["--image_dir", info_dir, "--output",
                               f"{root}/img_info.json"])
        sizes_ok = infos == {n: {"width": w, "height": h}
                             for n, (h, w) in INFO_SIZES.items()}
        img_info.main(["--all_color_imgs", f"{root}/colors", "--color_step",
                       str(COLOR_STEP)])
        probes = sorted(glob.glob(f"{root}/colors/*.jpg"))
        probes_equal = hashlib.sha256(b"".join(
            Path(p).read_bytes() for p in probes)).hexdigest() == CODEC_DIGESTS[
                "img_info:colors"]
        out["img_info"] = {"sizes_equal": sizes_ok, "probes": len(probes),
                           "probes_equal": probes_equal}
        check(sizes_ok and probes_equal
              and len(probes) == len(range(0, 256, COLOR_STEP)) ** 3
              and all(image_codec.image_size(p) == (128, 128) for p in probes),
              f"img_info: {out['img_info']}")
        print(f"img_info: sizes of {sorted(INFO_SIZES)} equal to the written "
              f"ones {sizes_ok}; {len(probes)} colour probes, their JPEG "
              f"bytes equal to Pillow's {probes_equal}", flush=True)

        # validate_checkpoints --dryrun: its fixture's JPEG bytes are
        # Pillow's, its report finite
        zero_counts(counters)
        t = time.perf_counter()
        report = validate_checkpoints.main(["--dryrun", "--workdir",
                                            f"{root}/validate"] + common)
        validate_s = time.perf_counter() - t
        ran = counts()
        files = sorted(glob.glob(f"{root}/validate/fixture/images/*.jpg"))
        digest = hashlib.sha256(b"".join(Path(p).read_bytes()
                                         for p in files)).hexdigest()
        out["validate"] = {"images": len(files), "seconds": validate_s,
                           "fixture_equal": digest == CODEC_DIGESTS[
                               "validate:fixture"],
                           "zero_shot_accuracy": report["zero_shot_accuracy"],
                           "launches": ran}
        check(out["validate"]["fixture_equal"]
              and len(files) == VALIDATE_FIXTURE["n_images"]
              and np.isfinite(report["zero_shot_accuracy"]),
              f"validate_checkpoints --dryrun: {out['validate']}")
        check(ran["K1"] > 0 and ran["K2"] > 0, f"validate_checkpoints "
                                                f"--dryrun launches {ran}")
        print(f"validate_checkpoints --dryrun --device {dev}: fixture of "
              f"{len(files)} JPEGs equal to Pillow's bytes "
              f"{out['validate']['fixture_equal']}, zero-shot accuracy "
              f"{report['zero_shot_accuracy']}, {validate_s:.2f} s; launches "
              f"{ran}", flush=True)

        # demo --detect on a YCCK JPEG: the detect step (K1, K2, K5), its
        # captions (utils/text) under non-ASCII class names
        out["demo_detect"] = run_demo_detect(counters, root, common, tiny)
        check(out["demo_detect"]["ok"], f"demo --detect: {out['demo_detect']}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 21 ({smi}) took {phase_s:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"phase 21: {failed}")
    out["seconds"] = phase_s
    return out


DEMO_IMAGE = "ycck_q75.jpg"      # demo --detect's input (Adobe transform 2)


def run_demo_detect(counters, root: str, common: list, tiny: bool) -> dict:
    """``demo.main --image <DEMO_IMAGE> --detect --conf 0 --labelmap ...
    --out det.png`` (X152-C4 at full width, its random weights; ``tiny``:
    the tiny detector on the CPU): the launches of its detect step, and
    the written PNG read back against ``overlay_detections`` of the
    detections it returned on the codec's decode of the file (whose digest
    is Pillow's, CODEC_DIGESTS) → readings with ``ok``."""
    import hashlib

    from cpt_tpu_torch.tools import demo
    from cpt_tpu_torch.utils import image_codec

    names = {i: f"clâsse {i} – {'ü' * (i % 3)}€ 中" for i in range(1, 1600)}
    with open(f"{root}/labelmap.json", "w") as f:
        json.dump({"idx_to_label": names}, f)
    path = str(CODEC_DIR / DEMO_IMAGE)
    zero_counts(counters)
    t = time.perf_counter()
    boxes, labels, scores = demo.main(
        ["--image", path, "--detect", "--conf", "0", "--labelmap",
         f"{root}/labelmap.json", "--out", f"{root}/det.png"] + common
        + (["--tiny"] if tiny else []))
    seconds = time.perf_counter() - t
    ran = {k: c.launches for k, c in counters.items()}
    img = image_codec.read_image(path)
    decoded = hashlib.sha256(img.tobytes()).hexdigest() == CODEC_DIGESTS[
        f"{DEMO_IMAGE}:RGB"]
    drawn = demo.overlay_detections(img.copy(), boxes, labels, scores, names)
    written = image_codec.read_image(f"{root}/det.png")
    equal = bool(np.array_equal(written, drawn))
    idle = [k for k in ran if k not in ("K1", "K2", "K5") and ran[k]]
    ok = (decoded and equal and len(boxes) > 0 and not idle
          and all(ran[k] > 0 for k in ("K1", "K2", "K5")))
    print(f"demo --image {DEMO_IMAGE} (YCCK, decode equal to Pillow's "
          f"{decoded}) --detect --out det.png: {len(boxes)} detections in "
          f"{seconds:.2f} s (set-up included); the PNG read back equal to "
          f"overlay_detections of them {equal}; launches {ran}", flush=True)
    return {"ok": ok, "detections": len(boxes), "seconds": seconds,
            "decode_equal": decoded, "out_equal": equal, "launches": ran}


# Phase 22: VinVL_L (``--model_size large``: OSCAR_LARGE, 24 × 1024, 16
# heads, FFN 4096) and the widths the JAX gates send to their Pallas kernels.
# (b) checks each new kernel code path against its plain version: K3's core
# at these (head_dim, heads) (24: the zero-padded tile; 512: the CUDA-core
# kernel) on VQA's eval batch,
K3_CORE_WIDTHS = ((24, 16), (32, 4), (80, 16), (128, 12), (256, 8), (512, 1))
# the row-LayerNorm GEMM at these N on the same 64 × 178 rows (the out
# projection's K = N) on the path ln_gemm_path names (a cluster at 1024, the
# split path past it),
LN_GEMM_WIDTHS = (1024, 1280, 2048, 4096)
# and K6 / K6b / K6c at (b, heads, S, bias, head_dim): 80 and 256 on the
# tile, 40 on the zero-padded tile, 36 on the CUDA-core kernels.
FLASH_WIDTH_SHAPES = [(8, 16, 178, "key", 80), (4, 8, 178, "key", 256),
                      (4, 8, 178, "3d", 40), (4, 4, 178, "key", 36)]
TOL["K4 LN GEMM"] = 1e-2
# Named faults of the new paths, as plain emulations: the zero-padded tile's
# pad chunk loaded from memory (``pad_not_zeroed``: q's and k's slices read
# the 8 columns past the head into Q·Kᵀ); the split LN path's merge with the
# last 128-column tile's statistics dropped (``tile_stats_dropped``); the
# cluster path's exchange reading rank 0's partial sums for every rank
# (``rank0_sums``: each row normalised by its first slice's statistics).
LN_PATH_FAULTS = {"cluster": ("rank0_sums",), "split": ("tile_stats_dropped",)}
# (a), (c) the paths' tolerances, bf16 on the card under "auto" against
# the f32 einsum path on the same weights rounded to bf16, as the largest
# |Δ| over the largest |logit| (VQA's logits; refcoco_cpt's at-mask MLM
# logits over the vocabulary), set as phase 13's were: 3× the sound gap of
# the calibration run (H100 80GB HBM3, 700 W; phase 22 alone), or the
# geometric mean of that gap and the smallest named fault's where lower.
# VQA at VinVL_L: bf16 5.678e-3 (the plain bf16 path 7.085e-3), the faults
# 0.1197 (K4's LN per slice) and 0.7446 (the bias): 1.7e-2 (3×). refcoco_cpt:
# 9.165e-3, the fault 0.2437: 2.7e-2 (3×). The widths: 7.799e-3 (384, 12
# layers), 7.880e-3 (1280), 6.056e-3 (1536), the smallest fault 4.802e-2
# (K4's LN per slice at 384: 3 slices): 1.9e-2, the geometric mean of it
# and the largest gap (3× would be 2.36e-2).
VINVL_TOL = {"vqa": 1.7e-2, "refcoco": 2.7e-2, "widths": 1.9e-2}
# Named faults: the classifier's bias dropped (VQA and the widths; its
# biases drawn as in phase 13) and K4's row LayerNorm taking each 128-column
# slice's statistics (``k4_ln_slice_stats``: the exchange of a cluster, or
# the split path's merge, skipped) in every layer.
# (c) the Oscar runner's widths that take the new paths under "auto": head_dim
# 16 (hidden 384 over 24 heads; 12 layers), 80 and the split LN path (hidden
# 1280, VinVL_L's 16 heads), 128 and the split path (hidden 1536, 12 heads)
WIDTH_RUNS = {"width_384": ["--hidden_size", "384"],
              "width_1280": ["--model_size", "large", "--hidden_size", "1280",
                             "--num_hidden_layers", "2"],
              "width_1536": ["--hidden_size", "1536", "--num_hidden_layers",
                             "2"]}


def predraw_weights(ranks: bool = False) -> float:
    """Draw the random reference-layout weights the full-width phases take
    into the cache of ``cached_random_weights``, which the caller has
    entered, in the order the phases ask for them: X152-C4 and Oscar-base
    at seed 0 (the resident models and the runners, and cut to their first
    layers phases 13 and 14 and the sweep's seed 0), Oscar-base at the seeds
    phase 11's tools draw their encoders from (88, ``gqa_cpt``'s
    ``--random_seed``; 7, the FT heads; 1, and the sweep's second seed),
    phase 15's discrete-code encoder (``code_vqa_fixture``'s 512 × 512
    codebook, 50 codes an image), then VinVL_L and ``WIDTH_RUNS`` for phase
    22 at seed 0. ``main`` runs it on a thread of its own beside phase 3 (numpy fills
    its arrays with the interpreter lock released). ``ranks``: only the
    rank processes' (X152-C4 and Oscar-base at seed 0). → seconds."""
    from cpt_tpu_torch.models.detector import convert as dconv
    from cpt_tpu_torch.models.detector.config import VINVL_X152C4
    from cpt_tpu_torch.tools import cpt_predict as cp
    from cpt_tpu_torch.tools import run_vqa
    from cpt_tpu_torch.utils import convert as cv

    t0 = time.perf_counter()
    dconv.random_vinvl_state_dict(VINVL_X152C4, seed=0)
    base = cp.bert_config()
    draws = [(base, 0)]
    if not ranks:
        draws += [(base, 88), (base, 7), (base, 1), (dataclasses.replace(
            base, img_feature_type="dis_code", code_voc=512, code_dim=512,
            code_size=50), 0)]
        draws += [(run_vqa.model_config(run_vqa.build_args().parse_args(f)), 0)
                  for f in (["--model_size", "large"], *WIDTH_RUNS.values())]
    for cfg, seed in draws:
        cv.random_oscar_state_dict(cfg, seed=seed)
    return time.perf_counter() - t0


def path_counters() -> dict:
    """The launchers that count their launches per code path: K3's core and
    the row-LayerNorm GEMM (under K3 and K4), K6, K6b and K6c."""
    from cpt_tpu_torch.kernels.gemm import attention_core, gemm_bias_residual_ln
    from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                             flash_mha_bwd_dq)

    return {"K3 core": attention_core, "LN GEMM": gemm_bias_residual_ln,
            "K6": flash_mha, "K6b": flash_mha_bwd_dkv, "K6c": flash_mha_bwd_dq}


def path_launches(zero: bool = False) -> dict:
    """Each launcher's launches by path since the last zeroing (then zeroed
    again if ``zero``)."""
    out = {}
    for name, fn in path_counters().items():
        out[name] = dict(fn.path_launches)
        if zero:
            for path in fn.path_launches:
                fn.path_launches[path] = 0
    return out


def core_pad_not_zeroed(qkv, kb, heads: int, scale: float):
    """K3's core on the zero-padded tile (head_dim a multiple of 8, not of
    16) with the pad chunk read from memory: each head's q and k slices
    carry the 8 columns that follow them in the packed row into Q·Kᵀ."""
    import torch

    b, s, h3 = qkv.shape
    d = h3 // 3 // heads
    flat = torch.cat([qkv.float(), qkv.new_zeros(b, s, 8).float()], -1)
    cols = (torch.arange(heads, device=qkv.device)[:, None] * d
            + torch.arange(d + 8, device=qkv.device)[None, :])
    q, k = flat[:, :, cols], flat[:, :, h3 // 3 + cols]
    v = qkv.float().reshape(b, s, 3, heads, d)[:, :, 2]
    sc = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
          + kb.float()[:, None, None, :])
    p = torch.softmax(sc, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h3 // 3)


def ln_tile_merge(y, gamma, beta, eps: float, dropped: int = 0):
    """The split path's LayerNorm in f32 as its row kernel forms it: each
    128-column tile's sum and centred sum of squares merged by Chan's
    formula, divided by the whole width; with ``dropped`` > 0 the last
    tiles' statistics are left out of the merge (a fault)."""
    n = y.shape[-1]
    ys = y.unflatten(-1, (-1, 128))
    ys = ys[..., :ys.shape[-2] - dropped, :]
    mu_t = ys.mean(-1)
    m2_t = (ys - mu_t[..., None]).square().sum(-1)
    mu = (128 * mu_t).sum(-1, keepdim=True) / n
    var = (m2_t.sum(-1, keepdim=True)
           + 128 * (mu_t - mu).square().sum(-1, keepdim=True)) / n
    return (y - mu) * (var + eps).rsqrt() * gamma + beta


def ln_tile_stats_dropped(y, gamma, beta, eps: float):
    """The split path with the last tile's statistics dropped from the
    merge."""
    return ln_tile_merge(y, gamma, beta, eps, dropped=1)


def ln_rank0_sums(y, gamma, beta, eps: float):
    """The cluster path's LayerNorm with every block reading rank 0's
    partial sums: each row normalised by its first 128-column slice's mean
    and variance."""
    y0 = y[..., :128]
    mu = y0.mean(-1, keepdim=True)
    var = (y0 - mu).square().mean(-1, keepdim=True)
    return (y - mu) * (var + eps).rsqrt() * gamma + beta


def check_core_widths(rows: list, b: int = 64, s_len: int = 178) -> None:
    """K3's core at each of ``K3_CORE_WIDTHS`` on the path its rule names,
    on a packed projection of std 1.5, against its plain version in f32 and
    beside SDPA, by device time, the last sequence's keys all masked; named
    faults: uniform attention, a dropped mask, a dropped scale, the ragged
    edge unmasked, pass 1's running sum unrescaled and, on the zero-padded
    tile, ``pad_not_zeroed``."""
    import torch
    import torch.nn.functional as F

    from cpt_tpu_torch.kernels.gemm import attention_core, attention_path
    from cpt_tpu_torch.ops.fused_attention import reference_attention_core

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(22)
    for hd, heads in K3_CORE_WIDTHS:
        hdim, tokens = hd * heads, b * s_len
        scale = 1.0 / hd ** 0.5
        qkv = (torch.randn(b, s_len, 3 * hdim, generator=g, device=dev)
               * 1.5).to(bf)
        kb = torch.where(torch.rand(b, s_len, generator=g, device=dev) > 0.3,
                         0.0, -10000.0)
        kb[-1] = -10000.0     # every key masked: the ragged edge must stay out
        qkv_no_q = qkv.clone()
        qkv_no_q[..., :hdim] = 0

        def ref(q, bias, sc=scale, heads=heads):
            return lambda: reference_attention_core(q, bias, heads, sc)

        faults = {"uniform": ref(qkv_no_q, kb), "no_mask": ref(qkv, kb * 0),
                  "no_scale": ref(qkv, kb, 1.0),
                  "edge_unmasked": lambda: core_edge_unmasked(qkv, kb, heads,
                                                              scale),
                  "no_rescale": lambda: core_no_rescale(qkv, kb, heads, scale)}
        if hd % 16 == 8:
            faults["pad_not_zeroed"] = lambda: core_pad_not_zeroed(
                qkv, kb, heads, scale)
        qh, kh, vh = qkv.view(b, s_len, 3, heads, hd).unbind(2)
        mask = kb[:, None, None, :].to(bf)
        path = attention_path(hd)
        compare("K3 core", f"qkv=[{b},{s_len},{3 * hdim}] heads={heads} "
                f"head_dim={hd} path={path}",
                lambda: attention_core(qkv, kb, heads, scale), ref(qkv, kb),
                ref(qkv, kb), rows, faults,
                work=(nbytes(qkv, kb) + tokens * hdim * 2,
                      4 * tokens * s_len * hdim, BF16_OPS_S),
                library=lambda: F.scaled_dot_product_attention(
                    qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
                    attn_mask=mask, scale=scale),
                device="attention_kernel")
        rows[-1]["path"] = path


def check_ln_gemm(rows: list, m: int, n: int) -> None:
    """The row-LayerNorm GEMM alone (K3's out projection, K = N) on the path
    ``ln_gemm_path`` names against its plain version in f32, beside
    ``torch.addmm`` for the product alone, by device time; named faults: the statistics per 128-column slice, the last k tile
    dropped, the residual or the bias dropped, and the path's own
    (``LN_PATH_FAULTS``). The bias's 128-column slices have different means
    (``slice_offsets``), so each statistics fault moves the output."""
    import torch

    from cpt_tpu_torch.kernels.gemm import gemm_bias_residual_ln, ln_gemm_path
    from cpt_tpu_torch.ops.fused_attention import layer_norm_f32

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(n)
    k = n
    # drawn on the card: numpy took seconds for these rows

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    a = (randn(m, k) * 0.5).to(bf)
    w = (randn(k, n) / k ** 0.5).to(bf)
    bias = randn(n) * 0.1 + torch.from_numpy(slice_offsets(
        np.random.RandomState(n), n)).float().to(dev)
    res = (randn(m, n) * 0.5).to(bf)
    gamma = torch.rand(n, generator=g, device=dev) + 0.5
    beta = randn(n) * 0.1
    af, wf, resf = a.float(), w.float(), res.float()
    rule = ln_gemm_path(n)

    def exact(w_=wf, b_=bias, r_=resf, norm=layer_norm_f32):
        return lambda: norm(af @ w_ + b_ + r_, gamma, beta, 1e-12)

    norms = {"rank0_sums": ln_rank0_sums,
             "tile_stats_dropped": ln_tile_stats_dropped}
    faults = {"ln_slice_stats": exact(norm=ln_slice_stats),
              "k_tail_dropped": exact(w_=k_tail_dropped(wf)),
              "no_residual": exact(r_=0.0), "no_bias": exact(b_=0.0)}
    faults.update({f: exact(norm=norms[f]) for f in LN_PATH_FAULTS[rule]})
    b_bf = bias.to(bf)
    compare("K4 LN GEMM", f"a=[{m},{k}] w=[{k},{n}] epilogue (c) path={rule}",
            lambda: gemm_bias_residual_ln(a, w, bias, res, gamma, beta, 1e-12),
            lambda: layer_norm_f32((a @ w + b_bf + res).float(), gamma, beta,
                                   1e-12).to(bf),
            exact(), rows, faults,
            work=(nbytes(a, w, bias, res, gamma, beta) + m * n * 2,
                  2 * m * k * n, BF16_OPS_S),
            library=lambda: torch.addmm(b_bf, a, w),
            device=("wgmma_residual", "residual_ln_rows"))
    rows[-1]["path"] = rule


@contextlib.contextmanager
def k4_ln_slice_stats():
    """Every ``BertLayer``'s K4 computed with the row LayerNorm's
    statistics per 128-column slice (``ffn_with_fault``), in the
    activations' dtype."""
    from cpt_tpu_torch.models.bert import model as port_model

    real = port_model.fused_ffn

    def faulty(x, w1, b1, w2, b2, gamma, beta, eps=1e-12, approximate=False):
        return ffn_with_fault(x, w1, b1, w2, b2, gamma, beta, eps, approximate,
                              "ln_slice_stats")

    port_model.fused_ffn = faulty
    try:
        yield
    finally:
        port_model.fused_ffn = real


def run_vinvl_large(counters, smi: str, rows: list, dev,
                    tiny: bool = False) -> dict:
    """Phase 22 (see the module docstring): (b) the new kernel paths, K3 and
    K4 at VinVL_L's eval batch; (a) ``run_vqa.main --model_size large`` (2
    steps, dropout on: no kernel; eval on 64 questions), one deterministic
    ``"flash"`` step of ``run_vqa.train`` on its model, ``refcoco_cpt.main
    --model_size large`` scoring one eval batch of 32 sequences; (c)
    ``run_vqa.main`` eval-only at ``WIDTH_RUNS``. Launch counts zeroed just
    before each path and read just after, per kernel and per code path.
    Gathers every reading, prints it, then raises on the first check that
    failed. ``tiny`` (a dry run of the code paths on the CPU in f32, where
    the launch checks fail): no kernel checks, hidden 512 over 2 layers,
    24-d features, 16 text and 6 region slots, the widths at 1 layer and a
    hidden size of at most 512."""
    import torch

    from cpt_tpu_torch.engine import scoring
    from cpt_tpu_torch.tools import refcoco_cpt, run_vqa

    failed = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failed.append(what)

    t_phase = time.perf_counter()
    path_launches(zero=True)
    if not tiny:
        check_k3(rows, 64, 178, 1024, 16)
        check_k4(rows, 64 * 178, hdim=1024, f=4096)
        check_core_widths(rows)
        for n in LN_GEMM_WIDTHS:
            check_ln_gemm(rows, 64 * 178, n)
        check_flash(rows, FLASH_WIDTH_SHAPES)
        check_flash_bwd(rows, FLASH_WIDTH_SHAPES)
    out = {"check_paths": path_launches(zero=True)}
    checks_s = time.perf_counter() - t_phase

    def gaps(name, logits, want, fault_logits):
        """The run's gap and each fault's to the f32 logits, over the
        largest |logit|, checked against VINVL_TOL[name]."""
        scale = float(np.abs(want).max())
        gap = float(np.abs(logits - want).max()) / scale
        faults = {f: float(np.abs(v - want).max()) / scale
                  for f, v in fault_logits.items()}
        tol = VINVL_TOL[name.split("_")[0]]
        check(logits.shape == want.shape and np.isfinite(logits).all()
              and gap <= tol, f"{name}: gap to f32 {gap} (tol {tol}), shapes "
              f"{logits.shape} {want.shape}")
        check(all(e > tol for e in faults.values()),
              f"{name}: a fault passes {faults} (tol {tol}, gap {gap})")
        return {"gap": gap, "fault_gaps": faults, "tol": tol, "scale": scale}

    def eval_launches(call, layers, n_batches=1):
        want = {k: 0 for k in counters}
        want.update({"K3": layers * n_batches, "K4": layers * n_batches})
        return call["launches"] == want

    dim = 24 if tiny else 2054
    flags = ["--device", dev.type, "--dtype", "float32" if tiny else "bfloat16",
             "--seed", "0"]
    small = ["--hidden_size", "512", "--num_hidden_layers", "2",
             "--img_feature_dim", str(dim)] if tiny else []
    short = ["--max_seq_length", "16", "--max_img_seq_length", "6"] if tiny else []
    layers = 2 if tiny else 24
    with tempfile.TemporaryDirectory() as root:
        fx = oscar_fixture(root, dim)
        vqa = ["--feat_file", fx["feat_file"], "--examples", fx["vqa_train"],
               "--val_examples", fx["vqa_val"], "--label2ans", fx["label2ans"],
               "--per_gpu_train_batch_size", "8"] + short
        # --- (a) run_vqa at VinVL_L: 2 steps, eval on the 64 val questions
        argv = vqa + ["--model_size", "large", "--num_train_epochs", "1",
                      "--output_dir", f"{root}/vqa_large"] + small + flags
        with Driven(run_vqa, ("evaluate",), counters, build=draw_biases) as rec:
            score = run_vqa.main(argv)
        model, final = rec.model, rec.calls[-1]
        data = final["args"][0]
        out["vqa_paths"] = path_launches(zero=True)
        c = model.config
        check(tiny or (c.hidden_size, c.num_hidden_layers,
                       c.num_attention_heads, c.intermediate_size)
              == (1024, 24, 16, 4096), f"vinvl_vqa config {c}")
        check(len(rec.steps) == 2 and all(np.isfinite(st["loss"])
                                          and not any(st["launches"].values())
                                          for st in rec.steps),
              f"vinvl_vqa steps {[(st['loss'], st['launches']) for st in rec.steps]}")
        check(len(rec.calls) == 1 and len(data) == 64
              and eval_launches(final, layers),
              f"vinvl_vqa eval launches {[x['launches'] for x in rec.calls]}")
        logits = final["result"][2]

        def vqa_logits(m):
            return run_vqa.evaluate(m, data, 64)[2]

        want = vqa_logits(ft_oracle(model))
        with config_changed(model, attention_impl="einsum", ffn_impl="dense"):
            plain = vqa_logits(model)
        with k4_ln_slice_stats():
            faulty = vqa_logits(model)
        bias = model.cls_out.bias.detach().float().cpu().numpy()
        vqa_out = gaps("vqa", logits, want, {"cls_bias_dropped": logits - bias,
                                             "k4_ln_slice_stats": faulty})
        vqa_out.update(score=float(score), plain_gap=float(
            np.abs(plain - want).max()) / vqa_out["scale"],
            launches=rec.total(), losses=[st["loss"] for st in rec.steps],
            ms_per_step=float(np.mean([st["ms"] for st in rec.steps])),
            eval_ms_per_batch=final["ms"])
        out["vinvl_vqa"] = vqa_out
        path_launches(zero=True)

        # one deterministic step under "flash": K6, K6b, K6c (16 heads) and
        # K4's forward 24 each, K3 none
        args = run_vqa.build_args().parse_args(argv + ["--max_steps", "1"])
        steps = []
        with config_changed(model, attention_impl="flash",
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0):
            zero_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_vqa.train(model, data, args, dev,
                          on_step=lambda step, loss: steps.append(loss))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        ran = {k: fn.launches for k, fn in counters.items()}
        want_ran = {k: 0 for k in counters}
        want_ran.update({"K4": layers, "K6": layers, "K6b": layers,
                         "K6c": layers})
        check(len(steps) == 1 and np.isfinite(steps[0]) and ran == want_ran,
              f"vinvl flash step: losses {steps}, launches {ran}")
        out["vinvl_flash_step"] = {"launches": ran, "loss": steps,
                                   "ms": step_ms,
                                   "paths": path_launches(zero=True)}
        del model, rec, final

        # --- refcoco_cpt at VinVL_L: one eval batch of 8 queries × 4 copies
        rfx = refcoco_fixture(root, dim)
        batches, built = [], []
        real_run, real_load = scoring.run_mlm_batch, refcoco_cpt.load_model

        def run_mlm_batch(fn, batch):
            at_mask = real_run(fn, batch)
            batches.append((batch, at_mask))
            return at_mask

        def load_model(*a, **kw):
            built.append(real_load(*a, **kw))
            return built[-1]

        scoring.run_mlm_batch, refcoco_cpt.load_model = run_mlm_batch, load_model
        try:
            zero_counts(counters)
            t0 = time.perf_counter()
            acc = refcoco_cpt.main(
                ["--data_file", rfx["data_file"], "--ann_file", rfx["ann_file"],
                 "--det_file", rfx["det_file"], "--model_size", "large",
                 "--per_gpu_eval_batch_size", "32"] + small + flags)
            torch.cuda.synchronize()
            main_ms = (time.perf_counter() - t0) * 1e3
            ran = {k: fn.launches for k, fn in counters.items()}
            rec_paths = path_launches(zero=True)
        finally:
            scoring.run_mlm_batch, refcoco_cpt.load_model = real_run, real_load
        model = built[-1]
        check(len(batches) == 1 and ran == dict(want_ran, K4=layers,
                                                 K3=layers, K6=0, K6b=0, K6c=0),
              f"vinvl_refcoco: {len(batches)} batches, launches {ran}")
        batch, at_mask = batches[0]
        fn = scoring.make_mlm_at_mask_fn(ft_oracle(model))
        want = scoring.run_mlm_batch(fn, batch)
        with k4_ln_slice_stats():
            faulty = scoring.run_mlm_batch(scoring.make_mlm_at_mask_fn(model),
                                           batch)
        rec_out = gaps("refcoco", at_mask, want, {"k4_ln_slice_stats": faulty})
        rec_out.update(accuracy=float(acc), launches=ran, main_ms=main_ms,
                       sequences=int(at_mask.shape[0]), paths=rec_paths)
        path_launches(zero=True)
        out["vinvl_refcoco"] = rec_out
        del model, built, batches

        # --- (c) the widths, eval only under "auto"
        for name, extra in WIDTH_RUNS.items():
            with Driven(run_vqa, ("evaluate",), counters,
                        build=draw_biases) as rec:
                run_vqa.main(vqa + extra + ["--num_train_epochs", "0"] + flags
                             + (["--img_feature_dim", str(dim),
                                 "--num_hidden_layers", "1", "--hidden_size",
                                 str(min(int(extra[extra.index(
                                     "--hidden_size") + 1]), 512))]
                                if tiny else []))
            width_paths = path_launches(zero=True)
            final = rec.calls[-1]
            model = final["model"]
            c = model.config
            logits = final["result"][2]
            wdata = final["args"][0]
            want = run_vqa.evaluate(ft_oracle(model), wdata, 64)[2]
            with k4_ln_slice_stats():
                faulty = run_vqa.evaluate(model, wdata, 64)[2]
            bias = model.cls_out.bias.detach().float().cpu().numpy()
            res = gaps("widths", logits, want, {
                "cls_bias_dropped": logits - bias, "k4_ln_slice_stats": faulty})
            path_launches(zero=True)
            res.update(launches=rec.total(), eval_ms_per_batch=final["ms"],
                       paths=width_paths,
                       geometry=(c.hidden_size, c.num_attention_heads,
                                 c.head_dim, c.intermediate_size,
                                 c.num_hidden_layers))
            check(len(rec.calls) == 1
                  and eval_launches(final, c.num_hidden_layers),
                  f"{name}: eval launches {final['launches']}")
            out[name] = res
            del model, rec, final

    main_paths = {}
    for key in ("vqa_paths", "refcoco") + tuple(WIDTH_RUNS):
        src = out[key] if key == "vqa_paths" else out[
            "vinvl_refcoco" if key == "refcoco" else key]["paths"]
        for kern, counts in src.items():
            for path, n in counts.items():
                main_paths.setdefault(kern, {}).setdefault(path, 0)
                main_paths[kern][path] += n
    for kern, counts in out["vinvl_flash_step"]["paths"].items():
        for path, n in counts.items():
            main_paths[kern][path] += n
    out["main_paths"] = main_paths
    every = {kern: {path: n + out["check_paths"][kern][path]
                    for path, n in counts.items()}
             for kern, counts in main_paths.items()}
    check(tiny or all(n > 0 for counts in every.values()
                      for n in counts.values()),
          f"a code path never launched in phase 22: {every}")
    phase_s = time.perf_counter() - t_phase
    v, r = out["vinvl_vqa"], out["vinvl_refcoco"]
    print(f"phase 22 VinVL_L and the widths ({smi}) in {phase_s:.1f} s "
          f"(kernel checks {checks_s:.1f} s): run_vqa --model_size large "
          f"{len(v['losses'])} steps at {v['ms_per_step']:.1f} host ms/step "
          f"(losses {v['losses']}), eval [64,178,1024] × 24 layers "
          f"{v['eval_ms_per_batch']:.1f} host ms/batch, logits gap to f32 "
          f"{v['gap']:.3e} (tol {v['tol']}; plain bf16 path "
          f"{v['plain_gap']:.3e}), faults "
          + ", ".join(f"{f} {e:.3e} ({e / v['tol']:.1f}x tol)"
                      for f, e in v["fault_gaps"].items())
          + f", score {v['score']:.2f}, launches {v['launches']}; flash step "
          f"{out['vinvl_flash_step']['ms']:.1f} host ms (loss "
          f"{out['vinvl_flash_step']['loss']}), launches "
          f"{out['vinvl_flash_step']['launches']}; refcoco_cpt --model_size "
          f"large {r['sequences']} sequences in {r['main_ms']:.1f} host ms, "
          f"at-mask logits gap {r['gap']:.3e} (tol {r['tol']}), faults "
          + ", ".join(f"{f} {e:.3e} ({e / r['tol']:.1f}x tol)"
                      for f, e in r["fault_gaps"].items())
          + f", accuracy {r['accuracy']:.2f}, launches {r['launches']}; "
          + "; ".join(f"{k} {out[k]['geometry']} (hidden, heads, head_dim, "
                      f"FFN, layers): gap {out[k]['gap']:.3e} (tol "
                      f"{out[k]['tol']}), faults "
                      + ", ".join(f"{f} {e:.3e} ({e / out[k]['tol']:.1f}x tol)"
                                  for f, e in out[k]["fault_gaps"].items())
                      + f", eval "
                      f"{out[k]['eval_ms_per_batch']:.1f} host ms, paths "
                      f"{out[k]['paths']}" for k in WIDTH_RUNS)
          + f"; launches by path on the main paths {main_paths}, in the "
          f"kernel checks {out['check_paths']}", flush=True)
    if failed:
        raise AssertionError(f"phase 22: {failed}")
    out["seconds"] = phase_s
    return out


def kernel_counters() -> dict:
    """Each kernel's wrapper by its name in KERNELS: each carries the
    ``launches`` count it adds one to where it launches its kernel."""
    from cpt_tpu_torch.ops.attention import (flash_mha, flash_mha_bwd_dkv,
                                             flash_mha_bwd_dq)
    from cpt_tpu_torch.ops.fused_attention import fused_attention_block
    from cpt_tpu_torch.ops.fused_ffn import fused_ffn
    from cpt_tpu_torch.ops.grouped_conv import (grouped_conv3x3,
                                                grouped_conv3x3_int8)
    from cpt_tpu_torch.ops.nms_pallas import nms_pallas
    from cpt_tpu_torch.ops.quant import ffn_int8
    from cpt_tpu_torch.ops.roi_align_pallas import batched_roi_align

    return {"K1": grouped_conv3x3, "K2": batched_roi_align,
            "K3": fused_attention_block, "K4": fused_ffn, "K5": nms_pallas,
            "K6": flash_mha, "K6b": flash_mha_bwd_dkv,
            "K6c": flash_mha_bwd_dq, "K1q": grouped_conv3x3_int8,
            "K7": ffn_int8}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json", default=None,
                   help="also write every measurement to this file")
    args = p.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    from cpt_tpu_torch.kernels import build
    from cpt_tpu_torch.utils import image_codec

    weights = contextlib.ExitStack()
    draws = weights.enter_context(cached_random_weights())
    # the host codec (c++) builds while nvcc builds the kernels; then the
    # SASS check (cuobjdump) and the full-width phases' random weights run
    # on threads of their own beside phase 3. The first torch.profiler
    # trace (CUPTI's loading, ~10 s) stays after the kernels' library is
    # loaded: started before it, later traces missed launches
    background = concurrent.futures.ThreadPoolExecutor(2)
    host = background.submit(image_codec.LIBRARY.get)
    build.lib()
    host.result()
    print(f"kernels built and loaded in {build.LIBRARY.build_seconds:.1f} s "
          f"({build.library_path().name}); the host codec in "
          f"{image_codec.LIBRARY.build_seconds:.1f} s "
          f"({build.host_library_path().name})", flush=True)
    gemm_sass = background.submit(check_gemm_sass, build)
    predraw = background.submit(predraw_weights)

    counters = kernel_counters()
    rows: list = []
    marks = [("build", time.perf_counter())]
    check_kernels(rows)
    marks.append(("3 kernels", time.perf_counter()))
    gemm_sass = gemm_sass.result()
    res, setup_s = build_resident()
    e2e = {"setup_s": setup_s,
           "ground": run_requests(res, counters, profile=True),
           "detect": run_detect_requests(res, counters)}
    flash = rebuilt_scorer(res, torch.bfloat16, attention_impl="flash")
    oracle = rebuilt_scorer(res, torch.float32, attention_impl="einsum",
                            ffn_impl="dense")
    e2e["flash_ground"] = run_requests(flash, counters,
                                       idle=("K3", "K5", "K6b", "K6c", "K1q",
                                             "K7"),
                                       oracle=oracle)
    check_flash_requests(e2e["ground"], e2e["flash_ground"])
    e2e["long_context"] = run_long_context(flash, oracle, res)
    del flash, oracle
    marks.append(("4 requests", time.perf_counter()))
    e2e.update(run_training(res, counters))
    marks.append(("5 training", time.perf_counter()))
    e2e["ffn_study"] = run_ffn_study(counters)
    e2e.update(run_int8_extraction(counters))
    marks.append(("6 int8", time.perf_counter()))
    e2e["windowed"] = run_windowed(res, counters, smi, rows)
    marks.append(("7 windowed", time.perf_counter()))
    e2e["serve"] = run_serve(counters, smi, rows)
    e2e["serve_resized"] = {"launches": e2e["serve"]["resized_launches"]}
    marks.append(("8 serve", time.perf_counter()))
    e2e["vcr"] = run_vcr(res, counters, smi, rows)
    e2e["vcr_train"] = e2e["vcr"]["train"]
    e2e["vcr_polygons"] = e2e["vcr"]["polygons"]
    marks.append(("9 vcr", time.perf_counter()))
    # phases 19-20's two rank processes draw their weights meanwhile
    mesh_root = weights.enter_context(tempfile.TemporaryDirectory())
    procs = RankProcesses(mesh_root)
    weights.callback(procs.close)
    e2e.update(run_other_tasks(res, counters, smi, rows))
    phase10_s = e2e.pop("seconds")
    ft = run_ft_baselines(res, counters, smi, rows)
    phase11_s = ft.pop("seconds")
    e2e.update(ft)
    tools = run_detector_tools(res, counters, [
        r["detect_launches"] for r in e2e["detect"]["requests"]])
    phase12_s = tools.pop("seconds")
    e2e.update(tools)
    dev, dt, bcfg = res.device, res.oscar.dtype, res.bert_cfg
    del res
    oscar = run_oscar_runners(counters, smi, rows, dev, dt, dataclasses.replace(
        bcfg, num_hidden_layers=OSCAR_LAYERS))
    phase13_s = oscar.pop("seconds")
    e2e.update(oscar)
    caption = run_captioning_phase(counters, smi, rows, dev, dt, bcfg)
    phase14_s = caption.pop("seconds")
    e2e.update(caption)
    pretraining = run_pretraining_phase(counters, smi, rows, dev, dt, bcfg)
    phase15_s = pretraining.pop("seconds")
    e2e.update(pretraining)
    det_train = run_detector_training(counters, smi, rows, dev)
    phase16_s = det_train.pop("seconds")
    e2e.update(det_train)
    scene_graph = run_scene_graph(counters, smi, rows, dev)
    phase17_s = scene_graph.pop("seconds")
    e2e.update(scene_graph)
    e2e["library"] = run_library_modules(counters, smi, rows, dev)
    phase18_s = e2e["library"].pop("seconds")
    # phases 19-20 share the two rank processes started above
    procs.go()
    try:
        e2e["shard_extract"] = run_process_runtime(counters, smi, procs,
                                                   mesh_root)
        phase19_s = e2e["shard_extract"].pop("seconds")
        mesh = run_mesh_phase(counters, smi, rows,
                              e2e["shard_extract"].pop("single_tsv"), procs,
                              mesh_root)
    finally:
        procs.close()
    files = run_image_files(counters, smi)
    vinvl = run_vinvl_large(counters, smi, rows, dev)
    phase22_s = vinvl.pop("seconds")
    marks.append(("10-22", time.perf_counter()))
    in_phases = [(what, round(sec, 1)) for thread, what, sec in draws
                 if thread == threading.main_thread().name]
    print(f"the random weights drawn beside phase 3 in "
          f"{predraw.result():.1f} s; drawn in the phases: {in_phases}",
          flush=True)
    background.shutdown()
    e2e.update(vinvl)
    weights.close()
    phase20_s = mesh.pop("seconds")
    phase21_s = files.pop("seconds")
    e2e["image_files"] = files
    for name in ("predict_image", "predict_webp", "predict_tiff", "coco_tsv",
                 "validate", "demo_detect"):
        e2e[name] = files[name]
    for sec, ran in mesh.pop("launches").items():
        e2e[f"mesh_{sec}"] = {"launches": ran}
    e2e["mesh"] = mesh
    per_kernel = {k: [r for r in rows if r["kernel"].split()[0] == k]
                  for k in KERNELS}

    # headline shape per kernel for the summary line: the most frequent
    # main-path call (layer3 blocks; the 16-candidate request's pooling;
    # S=120; erf gelu; the RPN's NMS; the serving shape; the training shape; K1q's layer3 blocks; K7
    # on the study's inputs); launches over the request, training, study
    # and int8 extraction paths, each counted from 0 around its run; K6's
    # ms and library_ms are device times (a mean of back-to-back launches
    # times the host at its size)
    headline = {"K1": 4, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0,
                "K6b": 0, "K6c": 0, "K1q": 4, "K7": 0}
    paths = ("ground", "detect", "flash_ground", "train", "auto_train",
             "ffn_study", "int8", "int8_static", "windowed", "serve", "vcr",
             "vcr_train", "gqa", "gqa_train", "vg", "vg_train", "seg",
             "rec_ft_train", "rec_ft", "gqa_ft_train", "gqa_ft", "vcr_ft_train",
             "vcr_ft", "test_detector", "attr_eval", "image_dir", "oscar_vqa",
             "oscar_gqa", "oscar_nlvr_pair", "oscar_nlvr_concat",
             "oscar_retrieval", "oscar_retrieval_rerank", "oscar_retrieval_cl",
             "caption_xe", "caption_eval", "caption_scst", "caption_beam",
             "caption_greedy", "caption_flash", "caption_cbs", "pretrain",
             "pretrain_k4", "dis_code_vqa", "explore_templates", "explore_soft",
             "detector_train", "sg_infer", "sg_train", "bbox_aug",
             "bbox_aug_scales", "serve_resized", "vcr_polygons",
             "resize_extract", "library",
             "shard_extract", "mesh_extract", "mesh_refcoco", "mesh_pipeline",
             "mesh_detector", "mesh_dryrun", "predict_image", "predict_webp",
             "predict_tiff", "coco_tsv", "validate", "demo_detect", "vinvl_vqa", "vinvl_flash_step", "vinvl_refcoco",
             *WIDTH_RUNS)
    summary = []
    for k, (fn_name, src, replaces) in KERNELS.items():
        r = per_kernel[k][headline[k]]
        summary.append({"name": f"{k} {fn_name}", "route": "cuda",
                        "source": src.split()[0], "sources": src.split(),
                        "replaces": replaces,
                        "launches": sum(e2e[p]["launches"][k] for p in paths),
                        "max_abs_err": max(x["max_abs_err"] for x in per_kernel[k]),
                        "ms": r.get("device_ms", r["ms"]),
                        "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r.get("library_device_ms",
                                            r["library_ms"])})
    print(f"phase 10 took {phase10_s:.1f} s, phase 11 {phase11_s:.1f} s, "
          f"phase 12 {phase12_s:.1f} s, phase 13 {phase13_s:.1f} s, phase 14 "
          f"{phase14_s:.1f} s, phase 15 {phase15_s:.1f} s, phase 16 "
          f"{phase16_s:.1f} s, phase 17 {phase17_s:.1f} s, phase 18 "
          f"{phase18_s:.1f} s, phase 19 {phase19_s:.1f} s, phase 20 "
          f"{phase20_s:.1f} s, phase 21 {phase21_s:.1f} s, phase 22 "
          f"{phase22_s:.1f} s; by wall clock: build and SASS "
          f"{marks[0][1] - t_start:.1f} s, "
          + ", ".join(f"phase {n} {t - t0:.1f} s" for (_, t0), (n, t) in
                      zip(marks, marks[1:]))
          + f"; the whole run "
          f"{time.perf_counter() - t_start:.1f} s",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "build_s": build.LIBRARY.build_seconds,
                       "gemm_sass": gemm_sass,
                       "checks": rows, "requests": e2e}, f, indent=1)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
