"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--profile OUT.json]

Phases, each ending in torch.cuda.synchronize(); any failure raises and the
script exits non-zero without printing a result:

1. device: require CUDA and print the card's name and power limit;
2. build: compile the CUDA kernels from the repository's sources, hold the
   library's shared-memory sizes against the Python formulas the dispatch
   ladder uses, and print how many blocks of the tensor-core kernel one SM
   holds, in K1's and K6's instantiation and in K8's (four blocks of four
   warps are what its design counts on), of each kernel of the tensor-core
   backward pair (three: what it is compiled for), of the split-TF32 kernel
   (two), of each kernel of the split-TF32 backward pair (two) and of the
   split-TF32 whole-head kernels at L = 16 and 32 (at least two) and of the
   split-TF32 whole-head backward at head dim 64 at L = 16, 77 and 112 (at
   least one; its shared memory held at every L up to 112, and L = 113
   refused), and print each tensor-core kernel's registers, stack and spills
   from the build's ``ptxas -v`` log;
3. kernels: each forward kernel against its plain PyTorch version at the main
   paths' shapes (K1 and K2 at the ViT-B/16 and ViT-L/14 shapes; K6, K8 with
   its log-sum-exp, and K5's flash branch at the ViT-L/14@336px tower's
   shapes; K5's whole-block branch at ViT-B/16's heads, (256, 12, 197, 64),
   causal and not, which at head dim 64 launches K8's tensor-core entries on
   the views, in fp32 the split-TF32 kernel (also held against
   ``tf32x3_reference``) and in bf16 mha_tc.cu (held within 1.5e-2 of the plain
   version at that kernel's KV block), its launches counted in ``mha_tf32``
   and ``mha_tc``; K8 with the causal mask and at head dims 8 and 16), fp32
   within 1e-5 and bf16 within 5e-2 (absolute), with median times. In bf16 at head dim 64 K1, K6
   and K8 launch the tensor-core kernel (ops/csrc/mha_tc.cu), held within
   1.5e-2 (twice the largest gap measured) of the KV-blocked plain version that
   rounds where it rounds: K1 at (256, 197, 2304) 12 heads, the causal
   (14, 77, 1536) 8 heads and (14, 77, 2304) 12 heads, (64, 257, 3072) 16
   heads, K6 at q (256, 577, 1024) with kv (256, 577, 2048) 16 heads, K8 at
   (4096, 577, 64) with the log-sum-exp, (512, 1024, 64) and the causal
   (512, 500, 64) and through K5's flash branch at (256, 16, 577, 64), and
   through all three entries at L = 1, 63, 64, 65, 129 at batch 3, causal and
   not (K6 not causal); the launches that took it are counted exactly, K8's
   log-sum-exp must sit within 1e-4 of the plain one and two K8 launches must
   give the same bits. In fp32 at head dim 64 K1, K6 and K8 launch the
   split-TF32 kernel (ops/csrc/mha_tf32.cu), held within 1e-5 of the fp32
   plain versions at K1's (256, 197, 2304) 12 heads, (64, 257, 3072) 16 heads
   and the causal (14, 77, 1536) 8 heads and (14, 77, 2304) 12 heads, at K6's
   q (64, 400, 1024) with kv (64, 400, 2048) 16 heads, at K8's (4096, 577, 64)
   and (512, 577, 64) with the log-sum-exp and the causal (512, 500, 64), and
   through all three entries at L = 1, 63, 64, 65, 129 at batch 3; its
   launches are counted exactly (none in bf16 or at other head dims), two
   launches on the same inputs must give the same bits, and it must sit within
   1e-5 of the emulation of its arithmetic (``tf32x3_reference``) while the
   emulation of plain TF32 must not sit within 1e-5 of the fp32 plain version.
   In fp32 at head dims 16 and 32 with L <= 32 K2 launches the split-TF32
   whole-head kernel (ops/csrc/mha_bld_tf32.cu), held within 1e-5 of the fp32
   plain version and of ``mha_bld_tf32x3_reference`` at the temporal model's
   scoring shapes, at (1024, 32, 128) and at L = 1, 7, 16, 31, 32 at batch 3,
   causal and not, at head dims 32 and 16; L=33 stays on mha.cu; its launches
   are counted exactly, and two launches of it and of K4's give the same bits
   at the training shapes, causal at L=23, at head dim 16 and at a batch of
   66,000;
3b. backward kernels: K3 and K4 against their plain backwards at the training
   step's shapes, fp32 within 1e-5 and bf16 within 5e-2 of max|ref|, with
   median times; in fp32 K4 launches the split-TF32 whole-head kernel
   (mha_bld_tf32.cu), held within 1e-5 of max|ref| of the plain backward and
   of ``mha_bld_bwd_tf32x3_reference`` there and at L = 1, 7, 16, 31, 32 at
   batch 3, causal and not, at head dims 32 and 16 (L=33 on mha_bwd.cu), its
   launches counted exactly; in fp32 at head dim 64 K3 launches the
   split-TF32 whole-head backward (mha_whole_tf32_bwd.cu), held within 1e-5 of
   max|ref| of the plain backward and of the same emulation on the unpacked
   q, k, v at the text towers' (14, 77, 1536) with 8 heads and (14, 77, 2304)
   with 12, causal, and at L = 1, 7, 16, 33, 77, 80, 112 at batch 3 with 2
   heads, causal and not (L = 113 and 117 on mha_bwd.cu), its launches counted
   exactly; two launches of it through K3, K4 and K5's backward give the same
   bits at the text towers' shapes and at L = 33 and 112, and plain TF32's
   emulation misses 1e-5;
3c. long backward kernels, the same limits: K7 at the ViT-L/14@336px shape
   (q, g (32, 577, 1024), kv (32, 577, 2048), 16 heads); K9 and K10 at
   (512, 577, 64) and at the ragged (8, 1100, 64), with the log-sum-exp and
   the output of K8; K3's entry at (32, 197, 2304), 12 heads, and
   ``fused_attention``'s backward at (32, 12, 197, 64), both past the
   whole-head kernel's shared memory and so on the KV-blocked pair, causal
   and not; K9 and K10 with the mask and at head dim 16; autograd through
   ``fused_attention`` at (32, 16, 577, 64) against its plain path; and the
   parity checks of ``anomalyclip_tpu_torch.scripts.bench_attn_bwd`` (2e-5 of
   max|ref|; the flash backward against float64 no noisier than twice the
   plain VJP). In bf16 at head dim 64 every one of these launches the
   tensor-core pair (ops/csrc/mha_tc_bwd.cu), held within BWD_TC_TOLERANCE of
   max|ref|; in fp32 at head dim 64 the split-TF32 pair
   (ops/csrc/mha_tf32_bwd.cu), held within 1e-5 of max|ref| of the fp32 plain
   backward and of the emulation of its arithmetic
   (``blocked_bwd_tf32x3_reference``); both at K7's path shape, at L = 1, 63,
   64, 65, 129 and 1100 at batch 3, at K9's and K10's (512, 577, 64), the
   ragged (8, 1100, 64) and the causal (64, 500, 64), and at K3's and K5's
   shapes past the whole-head kernel; the launches that took each pair are
   counted exactly (none at head dim 16), and two launches on the same inputs
   must give the same bits in either type;
3e. the shapes the reference computes by its XLA formulation, here on kernels:
   the temporal model at head dim 8 (emb 32, 4 heads), ``fused_attention`` at
   head dim 8, ``fused_mha_bld`` at head dim 16 and L=200 (its backward on
   the KV-blocked pair), ``fused_attention`` causal at L=500 and head dim 64
   (K8, K9 and K10 with the mask), and the causal backwards at L=197 (the
   KV-blocked pair with the mask; ``fused_attention``'s forward there on its
   whole-block branch, the split-TF32 kernel); forward and backward, the
   launches counted exactly, each within 1e-5 of the same call with the plain
   versions chosen;
3d. probe kernels (ops/csrc/mha_probe.cu), fp32 within 1e-5 and bf16 within 5e-2
   of max|ref|, with median times: the tile probe at the ViT-L/14@336px layer's
   shape (32, 577, 1024), 16 heads, on its three layouts and at K6's own and two
   other tilings (fp32, whose K and V do not fit at 577 keys, at L=360; the
   whole-row layout at L=400), ``twopass``, ``pair`` and ``nosoftmax`` there,
   ``probe_qkv_gb``'s four shapes, and a refusal that must raise (``whole`` at
   L=577 with fp32 staging);
4. slice: the UCF-Crime ViT-B/16 model at full width from seeded weights scores
   three synthetic uint8 videos (about 200, 700 and 1600 frames) through
   ``Predictor.score_frames`` in fp32; the kernel launch counts of that run are
   checked; the 700-frame video is held against the same call with the plain
   attention (fp32 within 1e-4, absolute), and a bf16 pass, whose launch
   counts are checked too, against its own plain-attention pass (within
   BF16_SLICE_TOL, absolute). Here and in 4b-4e every K1 and K6 launch of a
   bf16 run must have taken the tensor-core kernel and none of an fp32 run,
   every K1 and K8 launch at head dim 64 of an fp32 run the split-TF32
   kernel and none of a bf16 run, and every K2 and K4 launch (the temporal
   model, fp32 under either compute dtype) the split-TF32 whole-head kernels;
4b. training: the UCF-Crime training step from features at full width in fp32
   (batch 64: 32 abnormal and 32 normal videos of 512 x 512-d features), three
   steps through ``fit_steps`` with one step per epoch, so that epoch 0 trains
   at lr 0 and epoch 1 moves the weights; the kernel launch counts of that run
   are checked, and the same steps under the plain attention must agree: step
   1's loss terms within 1e-4, the 3-step losses at rtol 5e-4, the BN state
   within 1e-5 (the text tower's K1 and K3 and the temporal model's K2 and K4
   run split-TF32 products, so the two are close, not equal to the bit; every
   one of the 36 K3 launches takes the split-TF32 whole-head backward), and step
   1's gradients within 1e-4 of each leaf's max against the plain run that
   takes the kernel run's branches of the temporal model's LeakyReLU
   (``LeakyBranches``: where a pre-activation lies within a rounding of 0 the
   two runs would otherwise take different branches, and a conv weight's
   gradient jumps there by several times 1e-4 of its max; that gap is printed,
   not asserted);
4c. ViT-L/14@336px: the UCF-Crime model with the ViT-L/14@336px tower at full
   width from seeded weights scores one synthetic 200-frame video (one grid,
   two encode calls of 256 frames) in fp32, through the core rung into the
   flash kernel, and in bf16, through the q-tiled kernel; each run's launch
   counts are checked, and each is held against the same call with the plain
   attention (fp32 within 1e-4, bf16 within BF16_SLICE_TOL, absolute). Beside
   that end-to-end limit, which bounds what 24 bf16 layers make of one-step
   roundings, what catches a kernel: on 32 seeded frames in bf16, at each of
   the 24 layers one block under the kernels against the same block under the
   KV-blocked plain form, both on the plain run's own input, must agree
   within LOCAL_GAP_STEPS bf16 steps of that layer's residual stream
   (``scripts.probe_bf16_drift.local_gap_readings``);
4d. the image tower's gradient: ``encode_image`` on 32 seeded uint8 frames at
   full ViT-L/14@336px width and depth, loss sum(features^2),
   ``torch.autograd.grad`` w.r.t. every visual leaf, in bf16 (the qtile rung:
   24 K6 and 24 K7 launches, every one on the tensor cores) and in fp32 (the
   core rung: 24 K8 on the split-TF32 kernel, 24 K9 and 24 K10 on the
   split-TF32 pair); the launch counts are
   checked exactly and the gradients held against
   the same call with the plain attention (fp32 within 1e-4 of each leaf's
   max, bf16 within BF16_GRAD_TOL); then the same at ViT-B/16 width and
   depth, batch 32, fp32 (K1 forward, K3's entry backward on its blocked
   route, the split-TF32 pair);
4e. the probe and measurement scripts, each through its ``main`` with the launch
   counts of its run checked exactly: ``bench_attn_l14 --check`` with its default
   variants at (32, 577, 1024) in bf16 and at ``--seq 576``, and ``whole`` and
   ``pair`` at ``--seq 400``; ``probe_qkv_gb`` and ``probe_qtile_vmem`` at a few
   configurations; ``bench_attn_l14 --tower`` at full ViT-L/14@336px width and
   depth, batch 32, bf16 (24 K6 launches a forward under the fused kernels, none
   under identity and plain attention); ``validate_pickgb`` and
   ``validate_qtile_config`` to their exit codes (the latter's core rung at
   L=1024 and 1536 on K8's tensor-core entry); ``bench_mha_tc --sass`` (the
   tensor-core kernels, forward and backward, at the towers' shapes, K8 in bf16
   and K6 in fp32 among them, the split-TF32 backward pair at the fp32
   gradients' shapes, and their opcode mixes, then K2 and K4 at the temporal
   model's four shapes by device, event and host time, K1 and K3 at the two
   text towers' shapes by the same three clocks, and K5's whole-block branch
   at (256, 12, 197, 64)); ``bench_attn_bwd
   --qtile`` (K7's
   parity in fp32 on the split-TF32 pair, then the
   forward+backward step in bf16 on the tensor-core kernels);
   ``probe_bf16_drift`` at one seed and 8 frames (the ViT-L/14@336px tower by
   layer under the kernels and under three plain forms); ``probe_int8_drift``
   (the int8 tower by layer: ViT-B/16 fp32 at 32 frames, ViT-L/14@336px bf16
   at 8); ``bench_eval``,
   ``bench_latency --path both`` and ``bench_train_step`` at their default
   sizes. It prints how many device times by torch.profiler were measured
   and how many came back "not measured" (no session recorded any);
4f. data and evaluation: the UCF-Crime model at full width from features on
   disk. The port's synthetic generator writes a feature set at UCF-Crime's
   published width (256 normal and 256 abnormal training videos, 16 test
   videos of 300-2000 frames, 512-d, about 1.2 GB of .npy) into a temporary
   directory under build/, removed at the end; the port's
   ``AnomalyCLIPDataModule`` reads it with the repository's UCF-Crime label
   file. The loader alone is timed batch by batch over three epochs of eight
   batches of 64; then, the launch counts set to 0: ncentroid over the normal
   training videos in test mode, a ``GridScorer`` built, two epochs of
   ``fit_steps`` over the train loader (16 steps, each epoch begun through
   ``set_epoch``, resumed at epoch 1 of the warmup so that every step updates
   the weights), ``GridScorer.update`` with the trained state,
   ``evaluate_videos`` over the test loader and ``detection_metrics``. The
   launches are counted exactly (K1 12 a text-tower forward: the scorer's
   constructor, each step and the update; K3 12 a step; K2 and K4 two a
   temporal call and a backward), every one on its fp32 route; the labels
   must equal the annotation files' frame labels, the scores be finite and
   of the set's length, the test videos fill grid buckets 1, 2 and 4 and the
   metrics be finite. Under the plain attention: every step of the kernel
   run again from the state it started from, taking its LeakyReLU branches
   (as 4b), its gradients within 1e-4 of each leaf's max; the first three
   steps from the same initial state on the plain run's own loader, whose
   batches, and the loader-alone run's, must equal the kernel run's to the
   bit, agreeing as in 4b (step 1's loss terms within 1e-4, the losses at
   rtol 5e-4, the BN state within 1e-5); the kernel run's trained state
   evaluated must give the same labels, scores and class probabilities
   within 1e-4 and AUC, AP, mAUC and mAP within 1e-4. It prints the loader's
   seconds a batch alone and the training step's with the loader, each
   epoch's first apart from the others' median, the evaluation's seconds a
   video and frames a second over one pass, and the metrics, each beside
   the card's name and power limit. The feature set is written once, before
   4f, and 4g and 4h read it too;
4g. the training run: ``AnomalyCLIPTrainModule`` from ``ucf_fit_config`` (the
   port's composition of ``experiment=ucfcrime`` with FIT_VALUES and the paths;
   tests/test_torch_fit.py holds it to the JAX package's) on 4f's feature set, under
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` with
   CUBLAS_WORKSPACE_CONFIG=:4096:8 (both restored afterwards; an op that warns
   is named, and B is then held to A at C's tolerances). The launch counts set
   to 0: fit A, three epochs of eight steps at batch 64, a validation pass and
   a checkpoint after each, then ``test(state=...)``; fit B, the same with a
   SIGTERM raised after epoch 1's third step, which must raise
   ``TrainingPreempted`` with "saved boundary: epoch 0" and restore the
   previous handler, then a fresh module resumed from ``checkpoints/last``
   through epochs 1-2; ``test(ckpt_path=last)`` in a fresh module; the
   from-frames ncentroid of a module whose normal videos are FRAME_VIDEOS
   seeded uint8 videos of 64-300 frames (``seeded_frames``: the frame source
   with the JPEG decode replaced), ViT-B/16 at full width. The launches are
   counted exactly, every one on its fp32 route. Then fit C, A under
   ANOMALYCLIP_ATTN_IMPL=reference, and the from-frames pass again, with no
   launch. B must equal A to the bit (each epoch's losses, the metrics of
   epochs 1-2, every trainable leaf and the BN state at the end); A and C agree
   within 5e-4 relative on the losses and 1e-4 on AUC, AP, mAUC and mAP, the
   two ncentroids within 1e-4; A's run directory holds epoch_000-002, last,
   ncentroid.npy and metrics_{0,1,2}.json; epoch 0 (warmup, lr 0) leaves every
   leaf as initialised and saves nonzero AdamW moments; epoch 1 moves every
   leaf; the fresh module's test agrees with A's within RELOAD_TOL. It prints
   the seconds of each epoch, validation pass, checkpoint save and restore, a
   checkpoint's bytes and the resumed run's epochs beside A's, with the card's
   name and power limit;
4h. the command line, in the same deterministic mode on 4f's feature set,
   laid out as ``configs/data/ucfcrime.yaml`` reads it under UCFCRIME_ROOT
   (``Image-Features/``, ``Annotations/``, the temporal annotation file): a
   ViT-B/16 CLIP state dict at its published width in OpenAI's key layout
   (``openai_clip_shapes``), seeded, in fp16, written to a file; the launch
   counts set to 0: ``train_entry.main`` with ``experiment=ucfcrime``, the
   file as ``model.net.clip_ckpt_path``, ENTRY_EPOCHS epochs, dropout 0 and the
   csv logger (``clip_init`` left at the published default, so the module
   resolves the file through the registry); ``eval_entry.main`` with
   ``data=ucfcrime model=anomaly_clip_ucfcrime`` on its ``checkpoints/last``;
   ``hparams_search=ucfcrime_tpe`` with SWEEP_TRIALS one-epoch trials,
   SWEEP_STARTUP of them random; a ``-m`` multirun over ENTRY_LRS. The
   launches are counted exactly, every one on its fp32 route. The CLIP tree on
   the card must equal the file's fp16 values upcast, to the bit; the same
   run through ``AnomalyCLIPTrainModule`` built from the port's ``compose``
   directly (out of the count) must equal the entry's to the bit (each
   epoch's losses, validation and test metrics, every trainable leaf and the
   BN state), with no op warning under deterministic mode; the eval's AUC,
   AP, mAUC and mAP within RELOAD_TOL of the run's test; the search's trials
   finite (so the last is drawn by the Parzen model), a finite best, each
   trial's run directory; the multirun's two run directories. It prints the
   seconds to compose, to read and convert the CLIP file (and its bytes), to
   build the module, of each epoch, the test pass, the whole eval entry, each
   trial and each job, with the card's name and power limit. The run's
   directory and the CLIP file are kept for 4i;
4i. the serving surface, on 4h's run (``checkpoints/last``, its
   ncentroid.npy, the CLIP file) and 4f's feature set under UCFCRIME_ROOT.
   Every main-path call runs with the launch counts set to 0 just before it
   and read just after, and must launch exactly its K1 (all on ``mha_tf32``)
   and K2 (all on ``bld_tf32``) and nothing else: the text tower once a
   ``score_input`` and once an export, the image tower once an encode chunk,
   the temporal model's two axial attentions a layer once a scoring call. The
   references run outside those windows. The calls: ``predict.main`` on
   SERVE_VIDEOS test videos' ``.npy`` features, each prediction (the JSON's
   scores and top-class probabilities, six decimals) within SERVE_TOL of
   ``evaluate_videos``' scores and class probabilities for the video;
   ``score_input`` on each, and on a seeded SERVE_FRAME_VIDEO-frame uint8
   video, equal within SERVE_TOL to ``Predictor.score_frames`` (phase 4's
   entry) on the same model; ``serve`` over the same videos in its stdin mode
   and its watch mode (``stop_after``), one JSON per input or the phase fails
   (the service itself logs a bad input and goes on), each equal to the
   predict CLI's; the export CLI with the encoder, ``ServingArtifact.load`` on
   the card, and the artifact's scores within SERVE_TOL of the checkpoint's
   on the features and within ARTIFACT_FRAMES_TOL on the uint8 video
   (normalized on the host), the score graph at g = 1, 2 and 5 from the one
   export within SERVE_TOL of the scorer; ``eval_entry.main(artifact=...)``
   on the feature set, AUC, AP, mAUC and mAP within SERVE_TOL of the
   checkpoint's eval; ``extract_features.FeatureWriter`` on EXTRACT_FRAMES
   seeded uint8 videos, the ``.npy`` files within SERVE_TOL of
   ``encode_frames``; the graft entry's function (``graft_entry.entry()``:
   ViT-B/16, 512 frames, bf16) with every K1 launch on ``mha_tc``, within
   BF16_SLICE_TOL of itself under the plain attention; and one XD_FRAMES-frame
   (T, 512) fp32 feature ``.npy`` through ``predict.main`` in a subprocess,
   which counts its own launches (held as above), its scores within
   XD_CHUNK_TOL of chunk-aligned scoring of the same file (grids in batches
   of XD_CHUNK_GRIDS), its peak resident memory above what it holds once the
   CUDA context is up within XD_GROWTH_MIB. It prints the predict CLI's
   seconds and the scoring's alone a video, serve's seconds an input, the
   export's seconds and the artifact's bytes, the load's seconds, the
   artifact's and the checkpoint's scoring seconds a video, extraction frames
   a second, and the XD subprocess's seconds and resident memory after each
   stage and at its peak, with the card's name and power limit;
4j. the other two CLIP towers on the serving path, on 4h's run and 4f's feature
   set under UCFCRIME_ROOT. First every int8 GEMM shape of the int8 towers
   (``int8_gemm_shapes``: ViT-B/16's patch embed, qkv, out, fc, proj and final
   projection at a 256-frame chunk and the final projection at 8 frames, M <=
   16; ViT-L/14@336px's at TOWER_FRAMES frames, its patch embed's K = 588)
   through ``quant.int8_matmul`` equal to the fp64 product of the same int8
   operands. RN50: a seeded fp16 state dict at RN50's full shapes in OpenAI's
   key layout (``state_dict_from_params`` of ``init_clip_params`` with the BN
   running statistics drawn), written to a file; a module composed from
   ``experiment=ucfcrime`` with ``model.net.arch=RN50`` and the file (the CLIP
   on the card equal to the file's values upcast) writes its state at init and
   a seeded 1024-d ncentroid as a run directory of its own. Then, for RN50 on
   that run and for ``model.net.quantize=int8`` on 4h's, in fp32 and bf16:
   ``predict.main`` on phase 4i's seeded SERVE_FRAME_VIDEO-frame uint8 video
   (``seeded_decode``: the video decode replaced by the frames), a module built
   by ``load_module_and_state`` scoring it with ``score_input`` twice (cold,
   warm), within SERVE_TOL of the CLI's scores, and the same call under the
   plain attention: RN50 within 1e-4 (fp32) and BF16_SLICE_TOL (bf16). For
   int8 also: the tower's quantization timed, ``Predictor.score_frames`` (the fp
   tower, phase 4's entry) on the same frames and module, and ``serve`` over
   two inputs of the same video (one JSON each, within SERVE_TOL of
   ``score_input``); the int8 run is held to its plain run where the kernels
   meet it (``int8_local_gaps``: each layer's attention against the plain
   version on the layer's own qkv, fp32 within TOLERANCE, bf16 within
   TC_TOLERANCE) and end to end within INT8_NOISE_RATIO times its own gap to
   the fp tower (see INT8_NOISE_RATIO), its features of 256 frames within
   cosine INT8_COSINE of the fp tower's. Then the int8 ViT-L/14@336px tower
   from seeded weights on TOWER_FRAMES uint8 frames in fp32 (the core rung: K8
   on ``mha_tf32``) and bf16 (the qtile rung: K6 on ``mha_tc``, fed strided
   views of the packed qkv), twice to the same bits, held as the int8 scoring
   is and within cosine INT8_COSINE of the fp tower. Every main-path call runs
   in a window of its own and must launch exactly its K1, K2, K6 or K8 on its
   route (RN50's image tower is convs and an einsum pool: no kernel); it prints
   the times with the card's name and power limit;
4k. more than one device, on the one card: every rank is a process of its own
   (``chip_smoke.py --rank ROLE SPEC``, started by ``launch_ranks``) that calls
   ``parallel.mesh.init_distributed`` itself and then the port's entry points,
   LOCAL_RANK 0 for all, so that the ranks share cuda:0 over gloo (NCCL refuses
   two ranks on one card); each rank runs under ``deterministic_mode`` and
   counts its own launches and routes around its main path; a rank that fails,
   or does not end within RANK_TIMEOUT_S, fails the phase. (a) The published
   UCF-Crime experiment, as 4h runs it (ENTRY_EPOCHS epochs on 4f's feature
   set, dropout 0, seed 1024, the seeded fp16 ViT-B/16 file), through
   ``train_entry.main`` then ``eval_entry.main`` on its ``last``, in one process
   and in DP_RANKS gloo ranks (a half-batch of 16 videos each): every step's
   loss (the mean of the ranks') within DP_LOSS_RTOL of one process's, each
   scoring pass's per-frame scores (two validations, the test, the eval entry)
   and the validation and test metrics within DP_TOL, a digest of the ranks'
   trainable leaves and BN state at every epoch boundary equal between ranks,
   each rank's launches exact (K1 12 a step and a scoring pass, K3 12 a step,
   K2 two a step and a video the rank scores, K4 two a step, every one on its
   fp32 route). (c) The same run in a one-rank NCCL group, through the same
   data-parallel code: its losses, digests, scores and metrics equal to the
   run without a group to the bit, its launches exact. (b) ``predict.main``
   with ``trainer.model_parallel`` = TP_RANKS on TP_RANKS gloo ranks on
   TP_FRAMES seeded uint8 frames, in fp32 and bf16, from (a)'s one-process
   ``last``: the module takes the tensor-parallel tower, each rank's K1 and K2
   launches are exact (every K1 on ``mha_tf32``, bf16 ``mha_tc``) and every
   image-tower K1 launch runs 6 local heads on (B, 197, 1152), and each rank's
   scores sit within TP_TOL of the single tower's in this process. It prints
   the seconds of an epoch on two ranks beside one process, and of a warm
   scoring call on the tensor-parallel tower beside the single one, with the
   card's name and power limit: two ranks on one card measure the collectives'
   cost and time-slicing, not scaling;
4l. the JAX package's Orbax checkpoints, with no JAX on the machine: the
   committed fixture (ORBAX_FIXTURE: one epoch of the synthetic experiment at
   ViT-B/16's text width with its optimizer state, and the JAX converter's
   output; ``fixture.json`` beside them) copied with a ``last`` symlink. (a)
   ``orbax_reader.read_leaves`` reads both directories through the port's
   OCDBT store and zstd decoder, every leaf's sha256 equal to the JSON's, and
   none of ORBAX_FORBIDDEN in ``sys.modules`` afterwards (it prints whether
   ``zstandard`` is importable here at all, and the read rate); (b)
   ``eval_entry.main`` on ``last`` with the seeded CLIP file the JSON names,
   its AUC, AP, mAUC and mAP within ORBAX_METRIC_TOL of the JAX eval's; (c)
   ``train_entry.main`` resumed from ``last`` for one epoch, dropout 0, under
   ``deterministic_mode``, and again from the ``state.pt`` that (d)
   ``convert_ckpt.main`` writes of ``last`` (timed, equal to the Orbax state
   to the bit): the two runs' losses and final trainable leaves equal to the
   bit, the losses within ORBAX_LOSS_RTOL of the JAX resume's. The eval and
   each resume run in a window of their own, their K1-K4 launches exact, every
   one on its fp32 route. It prints the read rate, the eval's, each resume's
   and the conversion's seconds with the card's name and power limit;
5. profile (only with --profile): for fp32 and bf16, three warm calls of the
   700-frame video on the host clock, then one under torch.profiler, the same
   for one 256-frame encode chunk of the ViT-B/16 tower, of the int8 ViT-B/16
   tower on the same weights and of RN50 per dtype, the same
   for one warm training step, one warm call of the ViT-L/14@336px video
   per dtype and one warm step of the ViT-L/14@336px tower's gradient per
   dtype: device time against wall time, time by class of kernel and the
   top kernels, printed and written as JSON to OUT.json.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts (the scoring, training, ViT-L/14@336px,
gradient, script, data, training-run, command-line, serving, other-tower and
every rank's multi-device runs and the Orbax checkpoints' runs together), errors and times: ``ms`` the kernel's, ``plain_ms``
its plain version's, ``library_ms`` (also ``sdpa_ms``) that of
``torch.nn.functional.scaled_dot_product_attention`` for the same function
(forward for a forward kernel; forward and backward through autograd for a
backward kernel, with ``library_fwd_ms`` beside it), timed here and used
nowhere in the port, and ``bound_ms`` the least the card could take: the
larger of the operations (4 L^2 dh per batch entry and head forward, 10
backward, 6 and 8 for the two flash passes, half when causal) over 989 TFLOP/s
for bf16 operands or 495 / 3 = 165 TFLOP/s for fp32 (the split-TF32 rate of an
fp32-accurate product on the tensor cores), and the bytes (each input read and
each output written once) over 3.35 TB/s. fused_attention's whole-block
branch is on none of these paths (its shapes there take K1, K6 or, through
its flash branch, K8): its count is the launches of phase 4e's benchmark,
its error and times phase 3's in fp32 (the split-TF32 kernel of
mha_tf32.cu at head dim 64). ``mha_qkv_bwd``'s numbers are phase 3b's at the
ViT-B/16 text tower's shape in fp32, where it launches the split-TF32
whole-head backward (mha_whole_tf32_bwd.cu); ``whole_bwd_tf32`` is that
kernel, which K3, K4 and K5's backward launch in fp32 at head dim 64 with
L <= 112: its count is ``route_counts["whole_bwd_tf32"]`` over the same runs
(the training path's 36), its numbers K3's. ``mha_tc`` is the tensor-core kernel that K1, K6 and K8 launch in
bf16: its count is ``route_counts["mha_tc"]`` over the same runs, its numbers
the sums over the bf16 scoring paths' four shapes (phase 3); ``fused_mha_qtile``'s
numbers are that kernel's too, at its one path shape. ``blocked_bwd_tc`` is the
tensor-core backward pair that K7, K9, K10 and the KV-blocked route of K3, K4
and K5's backward launch in bf16 at head dim 64: its count is
``route_counts["blocked_bwd_tc"]`` over the same runs, its numbers the pair's at
K7's path shape, which are ``mha_qtile_bwd``'s too (K9's and K10's path is the
fp32 tower: their numbers are the split-TF32 pair's). ``blocked_bwd_tf32`` is
the split-TF32 backward pair that the same entries launch in fp32 at head dim
64: its count is ``route_counts["blocked_bwd_tf32"]`` over the same runs, its
numbers K7's in fp32 at the same path shape. ``bld_tf32`` and
``bld_bwd_tf32`` are the split-TF32 whole-head kernels that K2 and K4 launch
in fp32 at head dims 16 and 32 with L <= 32: their counts are
``route_counts["bld_tf32"]`` and ``["bld_bwd_tf32"]`` over the same runs, their
numbers K2's (phase 3) and K4's (phase 3b) at the temporal model's shapes,
which are ``fused_mha_bld``'s and ``mha_bld_bwd``'s too. ``mha_tf32`` is the
split-TF32 kernel that K1, K6 and K8 launch in fp32 at head dim 64: its count is
``route_counts["mha_tf32"]`` over the same runs, its numbers the sums over the
fp32 scoring paths' four shapes (phase 3); on their fp32 paths
``fused_mha_qkv``'s and ``flash_attention_heads``' numbers are that kernel's
too. The six probe wrappers'
numbers are phase 3d's at (32, 577, 1024) in
bf16 (``probe_mha_qkv``: its four shapes summed; ``probe_mha_whole``: L=400) and
their counts phase 4e's; ``nosoftmax_mha`` computes no function the library has,
so its ``library_ms`` is null.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# video length -> the 32x16-frame grids that cover it (buckets 1, 2 and 4)
VIDEO_GRIDS = {200: 1, 700: 2, 1600: 4}
VIDEO_FRAMES = tuple(VIDEO_GRIDS)
CHECK_VIDEO = 700
KERNEL_SOURCE = {
    # on its paths, fp32 at head dim 64, the split-TF32 kernel (the bf16 paths'
    # is mha_tc's line)
    "fused_mha_qkv": "anomalyclip_tpu_torch/ops/csrc/mha_tf32.cu",
    # on their paths, the temporal model in fp32 at head dim 32, L=32 and 16:
    # the split-TF32 whole-head kernels
    "fused_mha_bld": "anomalyclip_tpu_torch/ops/csrc/mha_bld_tf32.cu",
    # on its path, the text tower's CoOp gradient in fp32 at head dim 64, L=77:
    # the split-TF32 whole-head backward
    "mha_qkv_bwd": "anomalyclip_tpu_torch/ops/csrc/mha_whole_tf32_bwd.cu",
    "mha_bld_bwd": "anomalyclip_tpu_torch/ops/csrc/mha_bld_tf32.cu",
    # on its path, the bf16 ViT-L/14@336px tower, the tensor-core kernel
    "fused_mha_qtile": "anomalyclip_tpu_torch/ops/csrc/mha_tc.cu",
    # on its path, the fp32 ViT-L/14@336px tower, the split-TF32 kernel
    "flash_attention_heads": "anomalyclip_tpu_torch/ops/csrc/mha_tf32.cu",
    # its whole-block branch at head dim 64: K8's tensor-core entries, in fp32
    # the split-TF32 kernel (mha.cu's acl_mha_bld_fwd at the smaller head dims)
    "fused_attention": "anomalyclip_tpu_torch/ops/csrc/mha_tf32.cu",
    # on its path, the bf16 ViT-L/14@336px tower's gradient, the tensor-core pair
    "mha_qtile_bwd": "anomalyclip_tpu_torch/ops/csrc/mha_tc_bwd.cu",
    # their path is the fp32 tower's gradient: the split-TF32 pair
    "flash_dq": "anomalyclip_tpu_torch/ops/csrc/mha_tf32_bwd.cu",
    "flash_dkv": "anomalyclip_tpu_torch/ops/csrc/mha_tf32_bwd.cu",
    # the kernel K1 and K6 launch in bf16 at head dim 64, counted by
    # route_counts["mha_tc"]
    "mha_tc": "anomalyclip_tpu_torch/ops/csrc/mha_tc.cu",
    # the pair the KV-blocked backward launches in bf16 at head dim 64, counted by
    # route_counts["blocked_bwd_tc"]
    "blocked_bwd_tc": "anomalyclip_tpu_torch/ops/csrc/mha_tc_bwd.cu",
    # the kernel K1 and K8 launch in fp32 at head dim 64, counted by
    # route_counts["mha_tf32"]
    "mha_tf32": "anomalyclip_tpu_torch/ops/csrc/mha_tf32.cu",
    # the pair the KV-blocked backward launches in fp32 at head dim 64, counted
    # by route_counts["blocked_bwd_tf32"]
    "blocked_bwd_tf32": "anomalyclip_tpu_torch/ops/csrc/mha_tf32_bwd.cu",
    # the kernels K2 and K4 launch in fp32 at head dims 16 and 32 with L <= 32,
    # counted by route_counts["bld_tf32"] and ["bld_bwd_tf32"]
    "bld_tf32": "anomalyclip_tpu_torch/ops/csrc/mha_bld_tf32.cu",
    "bld_bwd_tf32": "anomalyclip_tpu_torch/ops/csrc/mha_bld_tf32.cu",
    # the kernel K3, K4 and K5's backward launch in fp32 at head dim 64 with
    # L <= 112, counted by route_counts["whole_bwd_tf32"]
    "whole_bwd_tf32": "anomalyclip_tpu_torch/ops/csrc/mha_whole_tf32_bwd.cu",
}
PROBE_SOURCE = "anomalyclip_tpu_torch/ops/csrc/mha_probe.cu"
# probe wrapper -> the pallas_call sites of the JAX package's scripts it replaces
PROBE_REPLACES = {
    "probe_mha_qkv": ["scripts/probe_qkv_gb.py:51"],
    "probe_mha_qtile": ["scripts/probe_qtile_vmem.py:34", "scripts/bench_attn_l14.py:83",
                        "scripts/bench_attn_l14.py:201"],
    "probe_mha_whole": ["scripts/bench_attn_l14.py:179"],
    "twopass_mha": ["scripts/bench_attn_l14.py:150"],
    "pair_mha": ["scripts/bench_attn_l14.py:238"],
    "nosoftmax_mha": ["scripts/bench_attn_l14.py:279"],
}
REPLACES = {
    "fused_mha_qkv": "anomalyclip_tpu/ops/pallas/attention.py:423",
    "fused_mha_bld": "anomalyclip_tpu/ops/pallas/attention.py:88",
    "mha_qkv_bwd": "anomalyclip_tpu/ops/pallas/attention.py:291",
    "mha_bld_bwd": "anomalyclip_tpu/ops/pallas/attention.py:273",
    "fused_mha_qtile": "anomalyclip_tpu/ops/pallas/attention.py:525",
    "flash_attention_heads": "anomalyclip_tpu/ops/pallas/attention.py:800",
    "fused_attention": "anomalyclip_tpu/ops/pallas/attention.py:1089",
    "mha_qtile_bwd": "anomalyclip_tpu/ops/pallas/attention.py:646",
    "flash_dq": "anomalyclip_tpu/ops/pallas/attention.py:904",
    "flash_dkv": "anomalyclip_tpu/ops/pallas/attention.py:943",
    "mha_tc": "anomalyclip_tpu/ops/pallas/attention.py:423",
    "blocked_bwd_tc": "anomalyclip_tpu/ops/pallas/attention.py:646",
    "mha_tf32": "anomalyclip_tpu/ops/pallas/attention.py:423",
    "blocked_bwd_tf32": "anomalyclip_tpu/ops/pallas/attention.py:646",
    "bld_tf32": "anomalyclip_tpu/ops/pallas/attention.py:88",
    "bld_bwd_tf32": "anomalyclip_tpu/ops/pallas/attention.py:273",
    "whole_bwd_tf32": "anomalyclip_tpu/ops/pallas/attention.py:291",
}
ALSO_REPLACES = {
    "mha_tf32": ["anomalyclip_tpu/ops/pallas/attention.py:800",
                 "anomalyclip_tpu/ops/pallas/attention.py:525"],
    "mha_tc": ["anomalyclip_tpu/ops/pallas/attention.py:525",
               "anomalyclip_tpu/ops/pallas/attention.py:800"],
    "blocked_bwd_tc": ["anomalyclip_tpu/ops/pallas/attention.py:904",
                       "anomalyclip_tpu/ops/pallas/attention.py:943"],
    "blocked_bwd_tf32": ["anomalyclip_tpu/ops/pallas/attention.py:904",
                         "anomalyclip_tpu/ops/pallas/attention.py:943"],
    "whole_bwd_tf32": ["anomalyclip_tpu/ops/pallas/attention.py:273"],
}
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
# the tensor-core kernel against its KV-blocked plain version (absolute): twice
# the largest gap measured over the towers' shapes, 7.8e-3. The outputs of randn
# inputs at L=577 have a standard deviation near 7e-2, so the bf16 tolerance of
# the older kernels would pass a dropped key there
TC_TOLERANCE = 1.5e-2
# K8's log-sum-exp from the tensor-core kernel against the plain one (absolute):
# both are fp32 sums of unrounded p, apart by the order of the sums and ex2.approx
LSE_TOLERANCE = 1e-4
# the tensor-core backward pair against its plain version, of max|ref| per case:
# twice the largest gap measured over phase 3c's cases, 3.1e-3 (K10 under the
# mask), rounded up. The CUDA-core pair's bf16 limit of 5e-2 would pass a wrong
# column of the row statistics in a ragged tile
BWD_TC_TOLERANCE = 7e-3
# phase 4c: one block under the kernels against the same block under the plain
# version, in bf16 steps of the layer's residual stream (one step is what a
# single rounding of the stream moves; the readings are 1 and once 1.5)
LOCAL_GAP_STEPS = 3
LOCAL_GAP_FRAMES = 32
FP32_SLICE_TOL = 1e-4
# the plain attention rounds as the kernel does, so the two bf16 passes differ
# only by summation order (about 3.4e-2 after ViT-B/16's twelve bf16 layers,
# 3.2e-2 after ViT-L/14@336px's 24); bf16 against fp32 differs by about 6.0e-2
# and 7.9e-2, which this limit rejects (NVIDIA H100 80GB HBM3, 700 W)
BF16_SLICE_TOL = 5e-2
L14_VIDEO_FRAMES = 200  # one 32x16-frame grid: 512 frames, two encode calls
GRAD_BATCH = 32  # frames per step of the image tower's gradient
FP32_GRAD_TOL = 1e-4  # of each leaf's max |gradient|
# of each leaf's max |gradient|: the kernel path and the plain path round alike
# and differ by summation order, amplified through 24 bf16 layers each way
BF16_GRAD_TOL = 5e-2
# the warm step with K7 on the CUDA-core pair (NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's
GRAD_STEP_BEFORE = {"ViT-L/14@336px bfloat16": "0.4785 s with K7 on mha_blocked_bwd.cu",
                    "ViT-L/14@336px float32": "1.0966 s with K9 and K10 on mha_blocked_bwd.cu"}
# the card's published peaks (NVIDIA H100 SXM, dense): what bound_ms is taken
# against. For fp32 operands the least time for an fp32-accurate product is the
# tensor cores' split-TF32 rate, 495 TFLOP/s of TF32 over the three products a
# product takes (3xTF32, as mha_tf32.cu and the library's fp32 attention
# compute it), not the 67 TFLOP/s of the CUDA cores' fp32 FMA
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES_PER_S = 3.35e12

# UCF-Crime training (anomalyclip_tpu/configs/model/anomaly_clip_ucfcrime.yaml,
# configs/data/ucfcrime.yaml): batch 64 = 32 abnormal + 32 normal videos
NUM_CLASSES, NORMAL_ID, HALF_BATCH, FEATURE_FRAMES = 14, 7, 32, 512
SOLVER = {"lr": 1e-5, "prompt_learner_ratio": 1, "text_projection_ratio": 1,
          "selector_model_ratio": 1, "temporal_model_ratio": 1}
OPTIMIZER = {"weight_decay": 0.2}
SCHEDULER = {"warmup_epochs": 5, "total_epoch": 50}
TRAIN_STEPS = 3
TRAIN_GRAD_TOL = 1e-4  # of each leaf's max |gradient|
TRAIN_LOSS_RTOL = 5e-4
TRAIN_BN_TOL = 1e-5
# phase 4f: a UCF-Crime feature set at its published width (512-d ViT-B/16
# features) from the port's synthetic generator. 256 + 256 training videos
# (UCF-Crime's list has 800 + 810) make epochs of eight batches of 64, so that
# a batch or a step inside an epoch is timed apart from an epoch's first; test
# videos of 300-2000 frames cover 1 to 4 grids of 32x16 frames (buckets 1, 2, 4)
FEATURE_SET = dict(num_normal=256, num_abnormal=256, num_test=16, min_frames=300, max_frames=2000)
FEATURE_DIM = 512  # ViT-B/16's embed dim
# training resumes at the start of epoch 1 of the 5-epoch warmup (lr = base / 5),
# so that every step updates the weights; two epochs of it, three of the loader
# alone; the plain attention repeats the first DATA_CHECK_STEPS on its own
DATA_START_EPOCH, DATA_EPOCHS, LOADER_EPOCHS, DATA_CHECK_STEPS = 1, 2, 3, 3
EVAL_METRICS = ("auc_roc", "auc_pr", "mean_mc_auroc", "mean_mc_aupr", "optimal_threshold")
EVAL_METRIC_TOL = 1e-4  # AUC, AP, mAUC and mAP, kernels vs plain attention (absolute)
CASE_CALLS = 32  # of a kernel in run_cases: one checked, one to warm, 30 timed
SCRIPT_ITERS = 10  # timed calls per variant or shape in the scripts of phase 4e
# phase 4g: the UCF-Crime training run (configs/experiment/ucfcrime.yaml, seed
# 1024) on FEATURE_SET, FIT_EPOCHS epochs; the preempted fit takes SIGTERM after
# PREEMPT_AFTER_STEPS steps of epoch 1; the from-frames ncentroid pass reads
# FRAME_VIDEOS seeded videos of 64-300 uint8 frames
UCF_SEED, FIT_EPOCHS, PREEMPT_AFTER_STEPS = 1024, 3, 3
FRAME_VIDEOS, FRAME_COUNTS = 4, (64, 300)
# what phase 4g sets apart from the published config: CLIP from seeded weights
# at full width, three epochs, the paths, the csv logger in the run's own
# directory, and dropout 0: the dropout generator restarts from seed + 17 at
# every fit(), resume included (as the JAX package's key does), so only
# without dropout can a resumed run repeat the uninterrupted one
# a fresh module's test pass from ``last`` against A's own on the same tensors
# and inputs: the same scoring at two points of one process differed by an fp32
# step (8.94e-8 on an NVIDIA H100 at 700 W), so it is held within RELOAD_TOL,
# not to the bit
RELOAD_TOL = 1e-6
# phase 4h: the published UCF-Crime experiment through the port's command line
# on 4f's feature set: ENTRY_EPOCHS epochs, then a TPE search of SWEEP_TRIALS
# one-epoch trials (SWEEP_STARTUP random ones first) and a multirun over
# ENTRY_LRS
ENTRY_EPOCHS, SWEEP_TRIALS, SWEEP_STARTUP = 2, 3, 2
ENTRY_LRS = ("1.e-5", "1.e-4")
FIT_VALUES = {"model.net.clip_init": "random-full", "model.net.select_idx_dropout_topk": 0.0,
              "model.net.select_idx_dropout_bottomk": 0.0, "trainer.max_epochs": FIT_EPOCHS}
FIT_OVERRIDES = tuple(FIT_VALUES)
TEMPORAL_ANNOTATIONS = "Temporal_Anomaly_Annotation_for_Testing_Videos.txt"
# phase 4i: the serving surface on 4h's run. SERVE_TOL: the same functions on
# the same inputs (the checkpoint's path twice, the artifact on features), up
# to the six decimals of a prediction's JSON; ARTIFACT_FRAMES_TOL: the
# artifact's encode graph reads frames normalized on the host (the same fp32
# arithmetic as on the card); XD_CHUNK_TOL: a JSON's six decimals against the
# same grids scored in batches of XD_CHUNK_GRIDS (tests/test_xd_scale.py's
# limit)
SERVE_VIDEOS, SERVE_FRAME_VIDEO, EXTRACT_FRAMES = 4, 700, (300, 100)
SERVE_TOL, ARTIFACT_FRAMES_TOL = 1e-6, 1e-5
XD_FRAMES, XD_CHUNK_GRIDS, XD_CHUNK_TOL = 100_000, 16, 1e-5
# the XD child's peak resident memory above what it holds once the CUDA context
# is up. Not its whole resident size, as tests/test_xd_scale.py bounds the JAX
# process's on the CPU: on the card's machine the resident size counts every
# page of the CUDA libraries torch maps (libtorch_cuda, cuBLAS, cuSPARSE, NCCL,
# ...), 4,542 MiB after `import torch` alone. Above the context (NVIDIA H100
# 80GB HBM3, 700 W): the CLIP file and the module 136 MiB, the 205 MB feature
# file 195 MiB, then the scoring, which maps cuDNN's precompiled engines (492
# MiB) and cuBLAS's on first use and holds the gathered copy and the
# bucket-padded grids (256 grids of 512 frames, 268 MB): 2,170 MiB at the
# peak. 3 GiB leaves 0.9 GiB for the spread between runs, which is not
# measured
XD_GROWTH_MIB = 3072
# phase 4j: the other two towers on the serving path. RN50 (CLIPConfig.rn50())
# from a seeded fp16 file at its full shapes, and the int8 tower
# (model.net.quantize=int8) on 4h's run, each scoring phase 4i's seeded
# SERVE_FRAME_VIDEO-frame uint8 video through the predict CLI; the int8
# ViT-L/14@336px tower on TOWER_FRAMES seeded frames. INT8_COSINE: the int8
# features against the fp tower's on the same frames (tests/test_quant.py's
# bound). The int8 tower's kernel run and its plain run are two roundings to
# int8 of nearly the same activations: a code at a rounding tie flips on an
# fp32 ulp, a flip moves a GEMM's output row by one quantization step of its
# input, and the residual stream carries it on, so that by the last layer a
# quarter of the codes differ and the features are 1-2% apart, as far as a
# one-ulp nudge of the input moves the plain run and nearly as far as the int8
# tower is from the fp tower (scripts/probe_int8_drift.py, NVIDIA H100 80GB
# HBM3, 700 W: ViT-B/16 fp32, 256 frames, kernel vs plain 1.355e-2 relative,
# nudge 1.366e-2, int8 vs fp 1.528e-2; 20-25% of the codes flipped at layer
# 12). So the
# kernels are held where the int8 run meets them, each layer's attention
# against the plain version on that layer's own qkv at the kernels' limits
# (fp32 TOLERANCE, bf16 TC_TOLERANCE), and end to end the kernel run within
# INT8_NOISE_RATIO times the int8 tower's own gap to the fp tower (two
# independent roundings of one size: sqrt(2) expected)
TOWER_FRAMES, INT8_COSINE, INT8_NOISE_RATIO = 32, 0.999, 2.0
SEEDED_VIDEO = "seeded_video.mp4"
# phase 4k: more than one device on the one card. Each rank is a process of its
# own (``chip_smoke.py --rank ROLE SPEC``) on the shared cuda:0 over gloo; NCCL
# runs as a one-rank group. DP_RANKS ranks train 4h's run (ENTRY_EPOCHS epochs,
# dropout 0, seed 1024) and evaluate its ``last`` through the entries; TP_RANKS
# ranks score 4i's video through the tensor-parallel tower. The limits: the
# losses at DP_LOSS_RTOL and the metrics and scores within DP_TOL of one
# process (its sums in another order), the parameters equal to the bit between
# ranks, the one-rank NCCL run equal to the bit to the run without a group, the
# TP scores within TP_TOL of the single tower. RANK_TIMEOUT_S: a rank that
# crashes or hangs fails the phase; each collective's own limit is half of it
DP_RANKS, TP_RANKS, RANK_TIMEOUT_S = 2, 2, 600
# the TP ranks score TP_FRAMES seeded uint8 frames (a 512-frame grid once
# padded, two encode chunks): their gloo all-reduces through host memory are
# most of the phase's time, so not 4i's SERVE_FRAME_VIDEO (four chunks)
TP_FRAMES = 256
DP_LOSS_RTOL, DP_TOL = 5e-4, 1e-4
TP_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# phase 4l: the JAX package's Orbax checkpoints, committed under ORBAX_FIXTURE
# by tests/helpers/make_orbax_fixture.py (the card's machine has no JAX to
# write one), read by the port with none of ORBAX_FORBIDDEN loaded. The eval's
# metrics are held to the JAX eval's within ORBAX_METRIC_TOL
# (tests/test_golden.py's tolerance), a resumed epoch's losses to the JAX
# resume's within ORBAX_LOSS_RTOL of each (the bound 4f holds a step's leaves to)
ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "orbax"
ORBAX_FORBIDDEN = ("jax", "orbax", "tensorstore", "zstandard")
ORBAX_METRIC_TOL, ORBAX_LOSS_RTOL = 1e-4, 1e-4


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")
    torch.cuda.synchronize()
    return smi


def phase_build() -> None:
    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.ops import build

    start = time.perf_counter()
    lib = build.load_library()
    print(f"[build] {build.library_path().name}: {time.perf_counter() - start:.2f} s")
    # the ladder and the wrappers decide from the Python formulas; the kernels
    # launch with their own: the two must agree at every shape of the paths
    checked = 0
    for l in (16, 32, 50, 77, 197, 257, 400, 577):
        for dh in (32, 64):
            require(lib.acl_mha_smem_bytes(l, dh) == A.mha_smem_bytes(l, dh), f"mha smem at {l, dh}")
            require(lib.acl_mha_bwd_smem_bytes(l, dh) == A.mha_bwd_smem_bytes(l, dh),
                    f"mha_bwd smem at {l, dh}")
            for code, itemsize in ((0, 4), (1, 2)):
                require(lib.acl_mha_qtile_smem_bytes(l, dh, code) == A.mha_smem_bytes(l, dh, itemsize),
                        f"qtile smem at {l, dh, itemsize}")
                require(lib.acl_flash_smem_bytes(dh, code) == A.flash_smem_bytes(dh, itemsize),
                        f"flash smem at {dh, itemsize}")
                require(lib.acl_blocked_bwd_smem_bytes(dh, code)
                        == A.blocked_bwd_smem_bytes(dh, itemsize),
                        f"blocked backward smem at {dh, itemsize}")
            checked += 1
    for dh in (8, 16):  # the small head dims: every formula at the tiny models' lengths
        for l in (4, 16, 200):
            require(lib.acl_mha_smem_bytes(l, dh) == A.mha_smem_bytes(l, dh), f"mha smem at {l, dh}")
            require(lib.acl_mha_bwd_smem_bytes(l, dh) == A.mha_bwd_smem_bytes(l, dh),
                    f"mha_bwd smem at {l, dh}")
        for code, itemsize in ((0, 4), (1, 2)):
            require(lib.acl_flash_smem_bytes(dh, code) == A.flash_smem_bytes(dh, itemsize),
                    f"flash smem at {dh, itemsize}")
            require(lib.acl_blocked_bwd_smem_bytes(dh, code) == A.blocked_bwd_smem_bytes(dh, itemsize),
                    f"blocked backward smem at {dh, itemsize}")
        checked += 1
    dh = A.MHA_TC_HEAD_DIM
    require(lib.acl_mha_tc_smem_bytes(dh) == A.mha_tc_smem_bytes(dh), "tensor-core kernel smem")
    for entries, strided in (("K1 and K6", 0), ("K8", 1)):
        blocks = lib.acl_mha_tc_blocks_per_sm(dh, strided)
        require(blocks >= 4, f"tensor-core kernel, {entries}: {blocks} blocks an SM")
        print(f"[build] tensor-core kernel, {entries}, head dim {dh}: {A.mha_tc_smem_bytes(dh)} B a "
              f"block, {blocks} blocks of 4 warps an SM")
    checked += 1
    for kernel, code in A.BWD_TC_PASSES.items():
        need = A.blocked_bwd_tc_smem_bytes(dh, kernel)
        require(lib.acl_blocked_bwd_tc_smem_bytes(dh, code) == need,
                f"tensor-core backward smem, {kernel}")
        blocks = lib.acl_blocked_bwd_tc_blocks_per_sm(dh, code)
        require(blocks == 3, f"tensor-core backward, {kernel} kernel: {blocks} blocks an SM")
        print(f"[build] tensor-core backward, {kernel} kernel, head dim {dh}: {need} B a block, "
              f"{blocks} blocks of 4 warps an SM")
    checked += 1
    from anomalyclip_tpu_torch.ops import attention_probes as P

    for l, rows, parts in ((577, 64, 2), (577, 120, 4), (400, 128, 1), (77, 32, 3)):
        part = P.kv_part_length(l, parts)
        for warps in P.PROBE_WARPS:
            for code, itemsize in ((0, 4), (1, 2)):
                for stage in {4, itemsize}:
                    require(lib.acl_probe_smem_bytes(l, 64, stage, warps)
                            == A.mha_smem_bytes(l, 64, stage, warps),
                            f"probe smem at {l, stage, warps}")
                for heads in (1, 2):
                    require(lib.acl_parts_smem_bytes(rows, part, 64, code, warps, heads)
                            == P.parts_smem_bytes(rows, part, 64, itemsize, warps, heads),
                            f"parts smem at {rows, part, itemsize, warps, heads}")
        checked += 1
    require(lib.acl_mha_tf32_smem_bytes(dh) == A.mha_tf32_smem_bytes(dh), "split-TF32 kernel smem")
    blocks = lib.acl_mha_tf32_blocks_per_sm(dh)
    require(blocks >= 2, f"split-TF32 kernel: {blocks} blocks an SM")
    print(f"[build] split-TF32 kernel, head dim {dh}: {A.mha_tf32_smem_bytes(dh)} B a block, "
          f"{blocks} blocks of 4 warps an SM")
    checked += 1
    for kernel, code in A.BWD_TC_PASSES.items():
        need = A.blocked_bwd_tf32_smem_bytes(dh, kernel)
        require(lib.acl_blocked_bwd_tf32_smem_bytes(dh, code) == need,
                f"split-TF32 backward smem, {kernel}")
        blocks = lib.acl_blocked_bwd_tf32_blocks_per_sm(dh, code)
        require(blocks == 2, f"split-TF32 backward, {kernel} kernel: {blocks} blocks an SM")
        print(f"[build] split-TF32 backward, {kernel} kernel, head dim {dh}: {need} B a block, "
              f"{blocks} blocks of 4 warps an SM")
    checked += 1
    for dh in A.BLD_TF32_HEAD_DIMS:
        for l in range(1, A.BLD_TF32_MAX_L + 1):
            for backward in (0, 1):
                require(lib.acl_mha_bld_tf32_smem_bytes(l, dh, backward)
                        == A.mha_bld_tf32_smem_bytes(l, dh, bool(backward)),
                        f"split-TF32 whole-head smem at {l, dh, backward}")
        checked += 1
        for l in (16, 32):
            blocks = [lib.acl_mha_bld_tf32_blocks_per_sm(l, dh, backward) for backward in (0, 1)]
            require(min(blocks) >= 2,
                    f"split-TF32 whole-head kernels at L={l}, dh {dh}: {blocks} blocks an SM")
            print(f"[build] split-TF32 whole-head kernels, head dim {dh}, L={l}: forward "
                  f"{A.mha_bld_tf32_smem_bytes(l, dh, False)} B a block, {blocks[0]} blocks of 4 warps "
                  f"an SM; backward {A.mha_bld_tf32_smem_bytes(l, dh, True)} B, {blocks[1]} blocks")
    for l in range(1, A.WHOLE_TF32_MAX_L + 1):
        require(lib.acl_mha_whole_tf32_smem_bytes(l) == A.mha_whole_tf32_smem_bytes(l),
                f"split-TF32 whole-head backward smem at L={l}")
    require(lib.acl_mha_whole_tf32_blocks_per_sm(A.WHOLE_TF32_MAX_L + 1) == -1,
            "the split-TF32 whole-head backward admits L past its limit")
    checked += 1
    for l in (16, 77, A.WHOLE_TF32_MAX_L):
        blocks = lib.acl_mha_whole_tf32_blocks_per_sm(l)
        require(blocks >= 1, f"split-TF32 whole-head backward at L={l}: {blocks} blocks an SM")
        print(f"[build] split-TF32 whole-head backward, head dim 64, L={l}: "
              f"{A.mha_whole_tf32_smem_bytes(l)} B a block of {-(-l // 16)} warps, {blocks} blocks an SM")
    print(f"[build] shared-memory formulas: library and Python agree at {checked} (L, dh) "
          f"pairs; card limit {A.smem_limit(torch.device('cuda'))} B per block")
    log = build.library_path().with_suffix(".log").read_text()
    for source in TENSOR_CORE_SOURCES:
        for kernel, usage in ptxas_usage(log, source):
            print(f"[build] ptxas, {source} {kernel}: {usage}")
    torch.cuda.synchronize()


# the sources whose kernels' registers and spills phase_build prints
TENSOR_CORE_SOURCES = ("mha_tc.cu", "mha_tc_bwd.cu", "mha_tf32.cu", "mha_tf32_bwd.cu", "mha_bld_tf32.cu",
                       "mha_whole_tf32_bwd.cu")


def ptxas_usage(log: str, source: str) -> list:
    """(kernel, "N registers, S B stack, T B spill stores, U B spill loads") for
    each kernel of ``source`` in the nvcc log that ops/build.py keeps beside the
    library (``-Xptxas -v``)."""
    section = log.split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    usage = []
    for entry in section.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        name = re.search(r"(?:blocked_dq|blocked_dkv|mha|mha_bld|mha_whole)_(?:tc|tf32)(?:_fwd|_bwd)?_kernel",
                         mangled)
        layout = re.search(r"Packed|Strided", mangled) if "mha_tc_kernel" in mangled else None
        layout = layout.group() if layout else None
        if "mha_bld_tf32" in mangled:  # instantiated at head dims 16 and 32
            layout = "dh " + re.search(r"ILi(\d+)E", mangled).group(1)
        kernel = (name.group() if name else mangled) + (f" ({layout})" if layout else "")
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        usage.append((kernel, f"{regs.group(1)} registers, {frame.group(1)} B stack, "
                              f"{frame.group(2)} B spill stores, {frame.group(3)} B spill loads"))
    return usage


FP32, BF16 = (torch.float32,), (torch.bfloat16,)
BOTH = FP32 + BF16
# multiply-adds x 2 per (batch entry, head, query, key, column), and tensors of
# B x H x L x dh elements read or written, by kind of kernel
ATTENTION_WORK = {"fwd": (4, 4), "bwd": (10, 7), "dq": (6, 5), "dkv": (8, 6)}


def attention_bound(kind: str, dims: tuple, dtype, causal: bool = False, stats: int = 0) -> tuple:
    """The least time the card could take for one attention call of ``kind`` over
    dims = (B, H, L, dh) -> (ms, "operations" or "bytes"): its operations (half
    when causal) over the peak rate for the operand type, or its bytes over the
    memory rate, each input read once and each output written once; ``stats``
    counts fp32 (B, H, L) row statistics read or written."""
    b, h, l, dh = dims
    per_pair, tensors = ATTENTION_WORK[kind]
    flops = per_pair * b * h * l * l * dh * (0.5 if causal else 1.0)
    nbytes = dtype.itemsize * tensors * b * h * l * dh + 4 * stats * b * h * l
    ops_ms, bytes_ms = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def packed_heads(t: torch.Tensor, parts: int, heads: int) -> tuple:
    """(B, L, parts * H * dh), lane order part-major -> ``parts`` (B, H, L, dh) views."""
    b, l, width = t.shape
    return tuple(t.view(b, l, parts, heads, width // (parts * heads)).permute(2, 0, 3, 1, 4))


def sdpa(q, k, v, causal: bool = False) -> torch.Tensor:
    """The library call the kernels are timed beside, over (B, H, L, dh)."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)


def sdpa_backward(q, k, v, g, causal: bool = False, wrt=(0, 1, 2)) -> tuple:
    """The library's forward and backward through autograd -> the gradients of
    the ``wrt`` of (q, k, v) for the output gradient g."""
    leaves = [t.detach().requires_grad_(i in wrt) for i, t in enumerate((q, k, v))]
    return torch.autograd.grad(sdpa(*leaves, causal), [leaves[i] for i in wrt], g)


@dataclasses.dataclass
class Case:
    """One kernel at one shape: how its input is made and cut, the kernel, its
    plain version, the library call on the same inputs, and its work."""

    name: str  # the entry of the kernels line
    shape: tuple  # printed
    in_shape: object  # fp32 tensors are drawn at this shape, or list of shapes, and cast
    kernel: object  # f(x) -> tensor or tuple; x the tensor, or the list of tensors
    plain: object
    heads: object  # f(x) -> the (B, H, L, dh) views (q, k, v[, g]) the library call takes
    prepare: object = None  # f(x) -> x with what the kernel needs besides, made once
    kind: str = "fwd"  # of ATTENTION_WORK
    causal: bool = False
    stats: int = 0  # fp32 row statistics read or written
    wrt: tuple = (0, 1, 2)  # a backward kernel's gradients, of (q, k, v)
    dtypes: tuple = BOTH  # checked
    path: tuple = FP32  # the dtypes whose numbers go into the kernels line
    relative: bool = False  # the tolerance is of max|ref| (the backwards) or absolute
    library: bool = True  # the library has a call for the same function
    tensor_cores: bool = False  # in bf16 a tensor-core kernel runs: held to tc_tolerance
    tc_tolerance: float = TC_TOLERANCE
    tf32: bool = False  # in fp32 each call launches the split-TF32 kernel once
    # f(x) -> the emulation of the split-TF32 arithmetic on the same inputs, which
    # an fp32 run must match within TOLERANCE (of max|ref| where ``relative``)
    emulated: object = None
    # in fp32 each call launches a split-TF32 whole-head kernel of mha_bld_tf32.cu
    # once (K2's or K4's)
    bld_tf32: bool = False
    # in fp32 each call launches the split-TF32 whole-head backward of
    # mha_whole_tf32_bwd.cu once (K3's, K4's or K5's at head dim 64)
    whole_tf32: bool = False


def run_cases(tag: str, cases: list, report: dict, gen: torch.Generator) -> None:
    """Each case's kernel against its plain version, with the median times of
    the kernel, the plain version and the library call, and the bound; the
    path's dtypes are summed into ``report[name]``."""
    from anomalyclip_tpu_torch.scripts._bench_util import median_ms

    for case in cases:
        several = isinstance(case.in_shape, list)
        x32 = [torch.randn(shape, device="cuda", generator=gen)
               for shape in (case.in_shape if several else [case.in_shape])]
        for dtype in case.dtypes:
            x = [t.to(dtype) for t in x32] if several else x32[0].to(dtype)
            if case.prepare is not None:
                x = case.prepare(x)
            got, want = case.kernel(x), case.plain(x)
            torch.cuda.synchronize()
            got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            scale = max(b.float().abs().max().item() for b in want) if case.relative else 1.0
            tight = case.tensor_cores and dtype == torch.bfloat16
            tol = (case.tc_tolerance if tight else TOLERANCE[dtype]) * scale
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
            emulation = ""
            if case.emulated is not None and dtype == torch.float32:
                emu = case.emulated(x)
                emu = emu if isinstance(emu, tuple) else (emu,)
                emu_err = max((a - b).abs().max().item() for a, b in zip(got, emu))
                require(emu_err <= tol, f"{case.name} {case.shape}: {emu_err:.3e} from the emulation "
                                        f"of its split-TF32 arithmetic (tol {tol:.3e})")
                emulation = f", {emu_err / scale:.3e} from the emulation"
                del emu
            del got, want
            ms, plain_ms = median_ms(lambda: case.kernel(x)), median_ms(lambda: case.plain(x))
            views = case.heads(x)
            dims = tuple(views[0].shape)
            if not case.library:
                fwd_ms = library_ms = None
                beside = "no library call computes this"
            elif case.kind == "fwd":
                fwd_ms = library_ms = median_ms(lambda: sdpa(*views, case.causal))
                beside = f"sdpa {library_ms:.4f} ms"
            else:
                fwd_ms = median_ms(lambda: sdpa(*views[:3], case.causal))
                library_ms = median_ms(lambda: sdpa_backward(*views, case.causal, case.wrt))
                beside = f"sdpa forward+backward {library_ms:.4f} ms (forward {fwd_ms:.4f})"
            bound_ms, bound_by = attention_bound(case.kind, dims, dtype, case.causal, case.stats)
            of_ref = f", {err / scale:.3e} of max|ref|" if case.relative and scale > 0 else ""
            of_ref += emulation
            print(f"[{tag}] {case.name} {case.shape} as {dims} causal={case.causal} "
                  f"{str(dtype).split('.')[-1]}: max|err| {err:.3e}{of_ref} (tol {tol:.3e}), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {beside}, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            entry = report.setdefault(case.name, {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "library_ms": 0.0 if case.library else None,
                "library_fwd_ms": None if case.kind == "fwd" else 0.0, "bound_ms": 0.0,
                "bound_by": bound_by, "largest_bound": 0.0,
            })
            if dtype in case.path:
                # one call at each of the path's shapes, summed
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["ms"] += ms
                entry["plain_ms"] += plain_ms
                if case.library:
                    entry["library_ms"] += library_ms
                entry["bound_ms"] += bound_ms
                if case.kind != "fwd":
                    entry["library_fwd_ms"] += fwd_ms
                if bound_ms > entry["largest_bound"]:  # what bounds the largest share
                    entry["largest_bound"], entry["bound_by"] = bound_ms, bound_by
            del views
        del x32, x
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


def phase_kernels(report: dict) -> None:
    """Each forward kernel against its plain version at the shapes and in the
    dtype its path runs."""
    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.ops.attention import (
        flash_attention_heads,
        flash_attention_reference,
        fused_attention,
        fused_attention_reference,
        fused_mha_bld,
        fused_mha_qkv,
        fused_mha_qtile,
        mha_bld_reference,
        mha_qkv_reference,
        mha_qtile_reference,
        reference_block,
        reset_launch_counts,
        route_counts,
    )

    # K1 and K6 against the plain version that rounds like the kernel the
    # operand type takes: whole rows in fp32 (mha.cu), KV blocks in bf16 at head
    # dim 64 (mha_tc.cu)
    def qkv_plain(t, h, causal):
        return mha_qkv_reference(t, h, causal, reference_block(t.dtype, t.shape[-1] // 3 // h))

    def qtile_plain(t, d, h):
        return mha_qtile_reference(t[..., :d], t[..., d:], h, reference_block(t.dtype, d // h))

    cases = []
    for b, l, d, h, causal in ((256, 197, 768, 12, False), (14, 77, 512, 8, True),
                               (14, 77, 768, 12, True)):  # the ViT-L/14 text tower
        cases.append(Case(
            "fused_mha_qkv", (b, l, 3 * d), (b, l, 3 * d),
            lambda t, h=h, c=causal: fused_mha_qkv(t, h, c),
            lambda t, h=h, c=causal: qkv_plain(t, h, c),
            lambda t, h=h: packed_heads(t, 3, h), causal=causal, tensor_cores=True, tf32=True,
        ))
    # the tensor-core kernel in bf16 through both entries: the image towers
    # (ViT-B/16, ViT-L/14), the causal text towers, the ViT-L/14@336px tower's q
    # and k|v; its own line of the kernels list sums the four shapes of the
    # scoring paths (ViT-L/14 at 224 px is printed only); then the ragged edges
    # at a small batch, causal and not
    for b, l, d, h, causal, path in (
        (256, 197, 768, 12, False, BF16), (14, 77, 512, 8, True, BF16),
        (14, 77, 768, 12, True, BF16), (64, 257, 1024, 16, False, ()),
    ):
        cases.append(Case(
            "mha_tc", (b, l, 3 * d), (b, l, 3 * d),
            lambda t, h=h, c=causal: fused_mha_qkv(t, h, c),
            lambda t, h=h, c=causal: qkv_plain(t, h, c),
            lambda t, h=h: packed_heads(t, 3, h), causal=causal, dtypes=BF16, path=path,
            tensor_cores=True,
        ))
    cases.append(Case(
        "mha_tc", (256, 577, 1024), (256, 577, 3 * 1024),
        lambda t: fused_mha_qtile(t[..., :1024], t[..., 1024:], 16),
        lambda t: qtile_plain(t, 1024, 16),
        lambda t: packed_heads(t, 3, 16), dtypes=BF16, path=BF16, tensor_cores=True,
    ))
    # K8 at the bf16 core rung's length past K6 (validate_qtile_config's L=1024)
    cases.append(Case(
        "mha_tc", (512, 1024, 64), (3, 512, 1024, 64),
        lambda t: flash_attention_heads(t[0], t[1], t[2], save_lse=True),
        lambda t: flash_attention_reference(t[0], t[1], t[2], save_lse=True),
        lambda t: tuple(t[:, :, None]), stats=1, dtypes=BF16, path=(), tensor_cores=True,
    ))
    for l in (1, 63, 64, 65, 129):
        for causal in (False, True):
            cases.append(Case(
                "mha_tc ragged", (3, l, 3 * 128), (3, l, 3 * 128),
                lambda t, c=causal: A.mha_qkv_fwd_kernel(t, 2, c),
                lambda t, c=causal: qkv_plain(t, 2, c),
                lambda t: packed_heads(t, 3, 2), causal=causal, dtypes=BF16, path=(),
                tensor_cores=True,
            ))
            cases.append(Case(
                "mha_tc ragged", (3, l, 64), (3, 3, l, 64),
                lambda t, c=causal: A.flash_fwd_kernel(t[0], t[1], t[2], True, c),
                lambda t, c=causal: flash_attention_reference(t[0], t[1], t[2], save_lse=True, causal=c),
                lambda t: tuple(t[:, :, None]), causal=causal, stats=1, dtypes=BF16, path=(),
                tensor_cores=True,
            ))
        cases.append(Case(
            "mha_tc ragged", (3, l, 128), (3, l, 3 * 128),
            lambda t: A.mha_qtile_fwd_kernel(t[..., :128], t[..., 128:], 2),
            lambda t: qtile_plain(t, 128, 2),
            lambda t: packed_heads(t, 3, 2), dtypes=BF16, path=(), tensor_cores=True,
        ))
    # K2 at the temporal model's scoring shapes: in fp32 the split-TF32
    # whole-head kernel (mha_bld_tf32.cu), held against the fp32 plain version
    # and the emulation of its arithmetic; in bf16 mha.cu
    for b, l, d, h in ((64, 32, 256, 8), (128, 16, 256, 8)):
        cases.append(Case(  # q | k v
            "fused_mha_bld", (b, l, d), (b, l, 3 * d),
            lambda t, h=h, d=d: fused_mha_bld(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], h),
            lambda t, h=h, d=d: mha_bld_reference(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], h),
            lambda t, h=h: packed_heads(t, 3, h), bld_tf32=True,
            emulated=lambda t, h=h, d=d: A.mha_bld_tf32x3_reference(
                t[..., :d], t[..., d:2 * d], t[..., 2 * d:], h),
        ))
    # and at the ragged lengths at batch 3, causal and not, at head dims 32 and
    # 16 (printed only); L=33 is past it: mha.cu takes it
    for d in (256, 128):
        for l in (1, 7, 16, 31, 32, 33):
            for causal in (False, True):
                cases.append(Case(
                    "fused_mha_bld ragged", (3, l, d), (3, l, 3 * d),
                    lambda t, d=d, c=causal: fused_mha_bld(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], 8, c),
                    lambda t, d=d, c=causal: mha_bld_reference(
                        t[..., :d], t[..., d:2 * d], t[..., 2 * d:], 8, c),
                    lambda t: packed_heads(t, 3, 8), causal=causal, dtypes=FP32, path=(),
                    bld_tf32=l <= 32,
                    emulated=(lambda t, d=d, c=causal: A.mha_bld_tf32x3_reference(
                        t[..., :d], t[..., d:2 * d], t[..., 2 * d:], 8, c)) if l <= 32 else None,
                ))
    # K6: the ViT-L/14@336px tower's bf16 shape (q and k|v from one tensor, as
    # the ladder's two GEMMs leave them), and an fp32 shape whose K and V fit
    # the admission limit, on the split-TF32 entry
    for b, l, dtypes, path in ((256, 577, BF16, BF16), (64, 400, FP32, ())):
        cases.append(Case(
            "fused_mha_qtile", (b, l, 1024), (b, l, 3 * 1024),
            lambda t: fused_mha_qtile(t[..., :1024], t[..., 1024:], 16),
            lambda t: qtile_plain(t, 1024, 16),
            lambda t: packed_heads(t, 3, 16), dtypes=dtypes, path=path, tensor_cores=True, tf32=True,
        ))
    # K8 at the per-head shape of the fp32 tower, with the lse; in bf16 on the
    # tensor-core entry (the plain version at that kernel's KV block)
    cases.append(Case(
        "flash_attention_heads", (4096, 577, 64), (3, 4096, 577, 64),
        lambda t: flash_attention_heads(t[0], t[1], t[2], save_lse=True),
        lambda t: flash_attention_reference(t[0], t[1], t[2], save_lse=True),
        lambda t: tuple(t[:, :, None]), stats=1, tensor_cores=True, tf32=True,
    ))
    # K8 with the causal mask, ragged on both axes, and at the small head dims
    # (on no path of the supported models: printed, not in the kernels line)
    for n, l, dh, causal in ((512, 500, 64, True), (64, 333, 16, False), (64, 333, 8, True)):
        cases.append(Case(
            f"flash_attention_heads at dh {dh}", (n, l, dh), (3, n, l, dh),
            lambda t, c=causal: flash_attention_heads(t[0], t[1], t[2], save_lse=True, causal=c),
            lambda t, c=causal: flash_attention_reference(t[0], t[1], t[2], save_lse=True, causal=c),
            lambda t: tuple(t[:, :, None]), causal=causal, stats=1, path=(), tensor_cores=dh == 64,
            tf32=dh == 64,
        ))
    # K5: its whole-block branch at ViT-B/16 heads, causal and not (on no path:
    # the kernels line reports these, in fp32), and its flash branch at the fp32
    # tower's split heads (strided views of one qkv), which launches K8 (held
    # against K8's plain version, at the block of the kernel the dtype takes)
    # (at head dim 64 its whole-block branch launches K8's tensor-core entries
    # on the views: in fp32 the split-TF32 kernel, held against the whole-row
    # plain version and the emulation, in bf16 mha_tc.cu, held against the plain
    # version at that kernel's KV block)
    for causal in (False, True):
        cases.append(Case(
            "fused_attention", (256, 12, 197, 64), (3, 256, 12, 197, 64),
            lambda t, c=causal: fused_attention(t[0], t[1], t[2], c),
            lambda t, c=causal: fused_attention_reference(t[0], t[1], t[2], c, reference_block(t.dtype, 64)),
            tuple, causal=causal, tensor_cores=True, tf32=True,
            emulated=lambda t, c=causal: A.tf32x3_reference(t[0], t[1], t[2], c),
        ))
    cases.append(Case(
        "fused_attention", (256, 16, 577, 64), (256, 577, 3, 16, 64),
        lambda t: fused_attention(*t.permute(2, 0, 3, 1, 4)),
        lambda t: flash_attention_reference(*t.permute(2, 0, 3, 1, 4)),
        lambda t: tuple(t.permute(2, 0, 3, 1, 4)), path=(), tensor_cores=True, tf32=True,
    ))
    # the split-TF32 kernel in fp32 through both entries, held against the fp32
    # plain versions: its own line of the kernels list sums the four shapes of
    # the fp32 scoring paths (the ViT-B/16 image tower, the two text towers, the
    # ViT-L/14@336px tower's heads); printed beside them the ViT-L/14 tower, the
    # tower gradient's heads and the causal flash shape, then the ragged edges
    # at batch 3, causal and not
    for b, l, d, h, causal, path in (
        (256, 197, 768, 12, False, FP32), (14, 77, 512, 8, True, FP32),
        (14, 77, 768, 12, True, FP32), (64, 257, 1024, 16, False, ()),
    ):
        cases.append(Case(
            "mha_tf32", (b, l, 3 * d), (b, l, 3 * d),
            lambda t, h=h, c=causal: fused_mha_qkv(t, h, c),
            lambda t, h=h, c=causal: mha_qkv_reference(t, h, c),
            lambda t, h=h: packed_heads(t, 3, h), causal=causal, dtypes=FP32, path=path, tf32=True,
        ))
    for n, l, causal, path in ((4096, 577, False, FP32), (512, 577, False, ()), (512, 500, True, ())):
        cases.append(Case(
            "mha_tf32", (n, l, 64), (3, n, l, 64),
            lambda t, c=causal: flash_attention_heads(t[0], t[1], t[2], save_lse=True, causal=c),
            lambda t, c=causal: flash_attention_reference(t[0], t[1], t[2], save_lse=True, causal=c),
            lambda t: tuple(t[:, :, None]), causal=causal, stats=1, dtypes=FP32, path=path, tf32=True,
        ))
    for l in (1, 63, 64, 65, 129):
        for causal in (False, True):
            cases.append(Case(
                "mha_tf32 ragged", (3, l, 3 * 128), (3, l, 3 * 128),
                lambda t, c=causal: A.mha_qkv_fwd_kernel(t, 2, c),
                lambda t, c=causal: mha_qkv_reference(t, 2, c),
                lambda t: packed_heads(t, 3, 2), causal=causal, dtypes=FP32, path=(), tf32=True,
            ))
            cases.append(Case(
                "mha_tf32 ragged", (3, l, 64), (3, 3, l, 64),
                lambda t, c=causal: A.flash_fwd_kernel(t[0], t[1], t[2], True, c),
                lambda t, c=causal: flash_attention_reference(t[0], t[1], t[2], save_lse=True, causal=c),
                lambda t: tuple(t[:, :, None]), causal=causal, stats=1, dtypes=FP32, path=(), tf32=True,
            ))
        cases.append(Case(
            "mha_tf32 ragged", (3, l, 128), (3, l, 3 * 128),
            lambda t: A.mha_qtile_fwd_kernel(t[..., :128], t[..., 128:], 2),
            lambda t: mha_qtile_reference(t[..., :128], t[..., 128:], 2),
            lambda t: packed_heads(t, 3, 2), dtypes=FP32, path=(), tf32=True,
        ))
    # K2 at head dim 16, the temporal model at emb 128 with 8 heads (bench_eval's
    # size; on no model path: printed, not in the kernels line)
    cases.append(Case(
        "fused_mha_bld at dh 16", (1024, 32, 128), (1024, 32, 3 * 128),
        lambda t: fused_mha_bld(t[..., :128], t[..., 128:256], t[..., 256:], 8),
        lambda t: mha_bld_reference(t[..., :128], t[..., 128:256], t[..., 256:], 8),
        lambda t: packed_heads(t, 3, 8), path=(), bld_tf32=True,
        emulated=lambda t: A.mha_bld_tf32x3_reference(t[..., :128], t[..., 128:256], t[..., 256:], 8),
    ))
    scratch = {}
    reset_launch_counts()
    run_cases("kernels", cases, scratch, torch.Generator(device="cuda").manual_seed(SEED))
    report.update({k: v for k, v in scratch.items() if k in KERNEL_SOURCE})
    # every bf16 launch of K1, K6 and K8 at head dim 64 took the tensor-core
    # kernel, and no other launch did
    bf16_cases = sum(c.tensor_cores and torch.bfloat16 in c.dtypes for c in cases)
    require(route_counts["mha_tc"] == CASE_CALLS * bf16_cases,
            f"tensor-core launches {route_counts} over {bf16_cases} bf16 cases of K1, K6 and K8")
    print(f"[kernels] {route_counts['mha_tc']} launches of the tensor-core kernel over "
          f"{bf16_cases} bf16 cases of K1, K6 and K8 at head dim 64; none in fp32 or at other head dims")
    # every fp32 launch of K1, K6 and K8 at head dim 64 took the split-TF32
    # kernel, and no other launch did
    tf32_cases = sum(c.tf32 and torch.float32 in c.dtypes for c in cases)
    require(route_counts["mha_tf32"] == CASE_CALLS * tf32_cases,
            f"split-TF32 launches {route_counts} over {tf32_cases} fp32 cases of K1, K6 and K8")
    print(f"[kernels] {route_counts['mha_tf32']} launches of the split-TF32 kernel over "
          f"{tf32_cases} fp32 cases of K1, K6 and K8 at head dim 64; none in bf16 or at other head dims")
    # every fp32 launch of K2 at head dims 16 and 32 with L <= 32 took the
    # split-TF32 whole-head kernel, and no other launch did (bf16, L=33, K5)
    bld_cases = sum(c.bld_tf32 and torch.float32 in c.dtypes for c in cases)
    require(route_counts["bld_tf32"] == CASE_CALLS * bld_cases and route_counts["bld_bwd_tf32"] == 0,
            f"split-TF32 whole-head launches {route_counts} over {bld_cases} fp32 cases of K2")
    print(f"[kernels] {route_counts['bld_tf32']} launches of the split-TF32 whole-head kernel over "
          f"{bld_cases} fp32 cases of K2 at L <= 32; none in bf16, at L=33 or through K5")
    check_tc_flash()
    check_tf32_kernel()
    check_bld_tf32()


def check_tc_flash() -> None:
    """K8 on the tensor-core kernel in bf16: its log-sum-exp against the plain
    version's (the quantity K9 and K10 read, in natural-log units of the scaled
    scores), its output against the plain version at the kernel's KV block, and
    two launches on the same inputs, which must give the same bits."""
    from anomalyclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for n, l, causal in ((4096, 577, False), (512, 1024, False), (512, 500, True)):
        q, k, v = torch.randn(3, n, l, 64, device="cuda", generator=gen).bfloat16()
        (out, lse), (again, lse_again) = (A.flash_fwd_kernel(q, k, v, True, causal) for _ in range(2))
        want_out, want_lse = A.flash_attention_reference(q, k, v, True, causal=causal)
        torch.cuda.synchronize()
        require(torch.equal(out, again) and torch.equal(lse, lse_again),
                f"K8 bf16 ({n}, {l}, 64): two launches of the tensor-core kernel differ")
        out_gap = (out.float() - want_out.float()).abs().max().item()
        lse_gap = (lse - want_lse).abs().max().item()
        require(out_gap <= TC_TOLERANCE and lse_gap <= LSE_TOLERANCE,
                f"K8 bf16 ({n}, {l}, 64) causal={causal}: out {out_gap:.3e} (tol {TC_TOLERANCE:g}), "
                f"lse {lse_gap:.3e} (tol {LSE_TOLERANCE:g})")
        print(f"[kernels] tensor-core K8 bf16 ({n}, {l}, 64) causal={causal}: two launches give the "
              f"same bits; out {out_gap:.3e} (tol {TC_TOLERANCE:g}), lse {lse_gap:.3e} "
              f"(tol {LSE_TOLERANCE:g}) from the plain version")
        del q, k, v, out, lse, again, lse_again, want_out, want_lse
    torch.cuda.empty_cache()


def check_tf32_kernel() -> None:
    """The split-TF32 kernel against the emulation of its arithmetic
    (``tf32x3_reference``) and of plain TF32 (one product of the big parts),
    both beside the fp32 plain version; and two launches on the same inputs,
    which must give the same bits (a fixed order of sums, no atomics)."""
    from anomalyclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    qkv = torch.randn(256, 197, 3 * 768, device="cuda", generator=gen)
    heads = list(torch.randn(3, 512, 577, 64, device="cuda", generator=gen))
    causal = list(torch.randn(3, 512, 500, 64, device="cuda", generator=gen))
    qtile = torch.randn(64, 400, 3 * 1024, device="cuda", generator=gen)
    q, kv = qtile[..., :1024], qtile[..., 1024:]
    runs = {
        "K1 (256, 197, 2304) 12 heads": (
            lambda: A.mha_qkv_fwd_kernel(qkv, 12, False),
            lambda passes: A.mha_qkv_tf32x3_reference(qkv, 12, False, passes),
            lambda: A.mha_qkv_reference(qkv, 12, False)),
        "K8 (512, 577, 64)": (
            lambda: A.flash_fwd_kernel(*heads, True)[0],
            lambda passes: A.tf32x3_reference(*heads, passes=passes),
            lambda: A.flash_attention_reference(*heads)),
        "K8 causal (512, 500, 64)": (
            lambda: A.flash_fwd_kernel(*causal, True, True)[0],
            lambda passes: A.tf32x3_reference(*causal, True, passes=passes),
            lambda: A.flash_attention_reference(*causal, causal=True)),
        "K6 (64, 400, 1024) 16 heads": (
            lambda: A.mha_qtile_fwd_kernel(q, kv, 16),
            lambda passes: A.mha_qtile_tf32x3_reference(q, kv, 16, passes),
            lambda: A.mha_qtile_reference(q, kv, 16)),
    }
    for what, (kernel, emulated, plain) in runs.items():
        once, again = kernel(), kernel()
        torch.cuda.synchronize()
        require(torch.equal(once, again), f"{what}: two launches of the split-TF32 kernel differ")
        fp32 = plain()
        gaps = {"3xTF32 emulation": (once - emulated(3)).abs().max().item(),
                "fp32 plain": (once - fp32).abs().max().item()}
        tf32_gap = (emulated(1) - fp32).abs().max().item()
        tol = TOLERANCE[torch.float32]
        require(max(gaps.values()) <= tol, f"{what}: {gaps} (tol {tol:g})")
        require(tf32_gap > tol, f"{what}: plain TF32 within {tf32_gap:.3e} of fp32, the check has no teeth")
        print(f"[kernels] split-TF32 {what}: two launches give the same bits; kernel against the "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f" (tol {tol:g}); plain TF32 emulated against fp32 {tf32_gap:.3e}")
    del qkv, heads, causal, qtile, q, kv
    torch.cuda.empty_cache()


def check_bld_tf32() -> None:
    """The split-TF32 whole-head kernels (K2 and K4 in fp32): two launches on the
    same inputs give the same bits, at the temporal model's training shapes,
    causal at a ragged length, at head dim 16 and at a batch past 65,535, each
    within 1e-5 (of max|ref| backward) of the fp32 plain versions; the emulation
    of plain TF32 misses that limit."""
    from anomalyclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    tol = TOLERANCE[torch.float32]
    for b, l, d, h, causal in ((1024, 32, 256, 8, False), (2048, 16, 256, 8, False),
                               (64, 23, 256, 8, True), (512, 32, 128, 8, True),
                               (66_000, 16, 64, 2, False)):
        q, kv, g = (torch.randn(b, l, w, device="cuda", generator=gen) for w in (d, 2 * d, d))
        k, v = kv[..., :d], kv[..., d:]
        A.reset_launch_counts()
        out, again = (A.mha_bld_fwd_kernel(q, k, v, h, causal) for _ in range(2))
        grads, grads_again = (A.mha_bld_bwd_kernel(q, k, v, g, h, causal) for _ in range(2))
        torch.cuda.synchronize()
        require(A.route_counts["bld_tf32"] == 2 and A.route_counts["bld_bwd_tf32"] == 2,
                f"K2, K4 ({b}, {l}, {d}): routes {A.route_counts}")
        require(torch.equal(out, again) and all(torch.equal(a, c) for a, c in zip(grads, grads_again)),
                f"K2, K4 ({b}, {l}, {d}) causal={causal}: two launches of the split-TF32 whole-head "
                f"kernels differ")
        want = A.mha_bld_reference(q, k, v, h, causal)
        want_grads = A.mha_bld_bwd_reference(q, k, v, g, h, causal)
        top = max(t.abs().max().item() for t in want_grads)
        gap = (out - want).abs().max().item()
        bwd_gap = max((a - c).abs().max().item() for a, c in zip(grads, want_grads)) / top
        require(gap <= tol and bwd_gap <= tol,
                f"K2, K4 ({b}, {l}, {d}): {gap:.3e}, {bwd_gap:.3e} (tol {tol:g})")
        if b <= 2048:
            tf32_gap = (A.mha_bld_tf32x3_reference(q, k, v, h, causal, passes=1) - want).abs().max().item()
            require(tf32_gap > tol, f"K2 ({b}, {l}, {d}): plain TF32 within {tf32_gap:.3e} of fp32, "
                                    f"the check has no teeth")
        print(f"[kernels] split-TF32 whole-head K2 and K4 ({b}, {l}, {d}) {h} heads causal={causal}: "
              f"two launches give the same bits; forward {gap:.3e}, backward {bwd_gap:.3e} of max|ref| "
              f"from the fp32 plain versions (tol {tol:g})")
        del q, kv, g, k, v, out, again, grads, grads_again, want, want_grads
    torch.cuda.empty_cache()


def phase_bwd_kernels(report: dict) -> None:
    """K3 and K4 against their plain backwards at the training step's shapes,
    and K4 at ragged lengths."""
    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.ops.attention import (
        mha_bld_bwd_kernel,
        mha_bld_bwd_reference,
        mha_qkv_bwd_kernel,
        mha_qkv_bwd_reference,
    )

    # the text towers' backward, causal: qkv (14, 77, 1536) and g with 8 heads
    # (ViT-B/16's, the path), (14, 77, 2304) with 12 (ViT-L/14's, printed); in
    # fp32 the split-TF32 whole-head backward (mha_whole_tf32_bwd.cu), held
    # against the emulation of its arithmetic too; in bf16 mha_bwd.cu
    cases = [Case(
        "mha_qkv_bwd", (14, 77, 3 * d), [(14, 77, 3 * d), (14, 77, d)],
        lambda t, h=h: mha_qkv_bwd_kernel(*t, h, True), lambda t, h=h: mha_qkv_bwd_reference(*t, h, True),
        lambda t, h=h: (*packed_heads(t[0], 3, h), *packed_heads(t[1], 1, h)),
        kind="bwd", causal=True, relative=True, path=path, whole_tf32=True,
        emulated=lambda t, h=h: qkv_whole_emulation(*t, h, True),
    ) for d, h, path in ((512, 8, FP32), (768, 12, ()))]
    # and at ragged lengths at batch 3 with 2 heads of 64, causal and not
    # (printed only); L=113 and 117 are past it: mha_bwd.cu takes them
    for l in (1, 7, 16, 33, 77, 80, 112, 113, 117):
        for causal in (False, True):
            whole = l <= A.WHOLE_TF32_MAX_L
            cases.append(Case(
                "mha_qkv_bwd ragged", (3, l, 3 * 128), [(3, l, 3 * 128), (3, l, 128)],
                lambda t, c=causal: mha_qkv_bwd_kernel(*t, 2, c),
                lambda t, c=causal: mha_qkv_bwd_reference(*t, 2, c),
                lambda t: (*packed_heads(t[0], 3, 2), *packed_heads(t[1], 1, 2)),
                kind="bwd", causal=causal, dtypes=FP32, path=(), relative=True, whole_tf32=whole,
                emulated=(lambda t, c=causal: qkv_whole_emulation(*t, 2, c)) if whole else None,
            ))
    # the temporal model's backward along segments and along frames, k and v
    # the two halves of one kv: t = q | k v, g; in fp32 the split-TF32
    # whole-head kernel, held against the emulation of its arithmetic too
    for b, l in ((1024, 32), (2048, 16)):
        cases.append(Case(
            "mha_bld_bwd", (b, l, 256), [(b, l, 3 * 256), (b, l, 256)],
            lambda t: mha_bld_bwd_kernel(*t[0].split(256, dim=-1), t[1], 8, False),
            lambda t: mha_bld_bwd_reference(*t[0].split(256, dim=-1), t[1], 8),
            lambda t: (*packed_heads(t[0], 3, 8), *packed_heads(t[1], 1, 8)),
            kind="bwd", relative=True, bld_tf32=True,
            emulated=lambda t: A.mha_bld_bwd_tf32x3_reference(*t[0].split(256, dim=-1), t[1], 8),
        ))
    # and at the ragged lengths at batch 3, causal and not, at head dims 32 and
    # 16 (printed only); L=33 is past it: mha_bwd.cu takes it
    for d in (256, 128):
        for l in (1, 7, 16, 31, 32, 33):
            for causal in (False, True):
                cases.append(Case(
                    "mha_bld_bwd ragged", (3, l, d), [(3, l, 3 * d), (3, l, d)],
                    lambda t, d=d, c=causal: mha_bld_bwd_kernel(*t[0].split(d, dim=-1), t[1], 8, c),
                    lambda t, d=d, c=causal: mha_bld_bwd_reference(*t[0].split(d, dim=-1), t[1], 8, c),
                    lambda t: (*packed_heads(t[0], 3, 8), *packed_heads(t[1], 1, 8)),
                    kind="bwd", causal=causal, dtypes=FP32, path=(), relative=True, bld_tf32=l <= 32,
                    emulated=(lambda t, d=d, c=causal: A.mha_bld_bwd_tf32x3_reference(
                        *t[0].split(d, dim=-1), t[1], 8, c)) if l <= 32 else None,
                ))
    A.reset_launch_counts()
    run_cases("bwd kernels", cases, report, torch.Generator(device="cuda").manual_seed(SEED + 1))
    # every fp32 launch of K4 at L <= 32 took the split-TF32 whole-head kernel,
    # none in bf16, at L=33 or of K3; every fp32 launch of K3 at L <= 112 the
    # split-TF32 whole-head backward, none in bf16 or at L = 113 and 117
    bld_cases = sum(c.bld_tf32 and torch.float32 in c.dtypes for c in cases)
    whole_cases = sum(c.whole_tf32 and torch.float32 in c.dtypes for c in cases)
    require_routes("backward kernels", 0, bld_bwd=CASE_CALLS * bld_cases, whole_bwd=CASE_CALLS * whole_cases)
    print(f"[bwd kernels] {A.route_counts['bld_bwd_tf32']} launches of the split-TF32 whole-head "
          f"backward over {bld_cases} fp32 cases of K4 at L <= 32; none in bf16, at L=33 or of K3")
    print(f"[bwd kernels] {A.route_counts['whole_bwd_tf32']} launches of the split-TF32 whole-head "
          f"backward at head dim 64 over {whole_cases} fp32 cases of K3 at L <= {A.WHOLE_TF32_MAX_L}; "
          f"none in bf16 or at L = 113 and 117")
    report["bld_tf32"] = dict(report["fused_mha_bld"])
    report["bld_bwd_tf32"] = dict(report["mha_bld_bwd"])
    report["whole_bwd_tf32"] = dict(report["mha_qkv_bwd"])
    check_whole_tf32()


def qkv_whole_emulation(qkv, g, heads: int, causal: bool, passes: int = 3) -> torch.Tensor:
    """The emulation of the split-TF32 whole-head backward's arithmetic over
    K3's packed qkv -> the packed dqkv."""
    from anomalyclip_tpu_torch.ops import attention as A

    return torch.cat(A.mha_bld_bwd_tf32x3_reference(*A._unpack_qkv(qkv), g, heads, causal, passes=passes),
                     dim=-1)


def check_whole_tf32() -> None:
    """The split-TF32 whole-head backward through its three callers: two
    launches on the same inputs give the same bits (K3 at the text towers'
    shapes and at ragged lengths, K4 with k and v the halves of one kv, K5's
    backward with the heads folded), each within 1e-5 of max|ref| of the fp32
    plain backward; the emulation of plain TF32 misses that limit."""
    from anomalyclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tol = TOLERANCE[torch.float32]

    def gap(got, want):
        return max((a - b).abs().max().item() for a, b in zip(got, want)) / max(
            b.abs().max().item() for b in want)

    for b, l, d, h, causal in ((14, 77, 512, 8, True), (14, 77, 768, 12, True), (3, 33, 128, 2, True),
                               (3, 112, 128, 2, False)):
        qkv, g = (torch.randn(b, l, w, device="cuda", generator=gen) for w in (3 * d, d))
        q, k, v = A._unpack_qkv(qkv)
        heads = [t.view(b, l, h, 64).transpose(1, 2) for t in (q, k, v, g)]
        A.reset_launch_counts()
        runs = [(A.mha_qkv_bwd_kernel(qkv, g, h, causal),) for _ in range(2)]
        runs += [A.mha_bld_bwd_kernel(q, k, v, g, h, causal) for _ in range(2)]
        runs += [A.fused_attention_bwd_kernel(*heads, causal) for _ in range(2)]
        torch.cuda.synchronize()
        require_routes(f"K3, K4, K5 ({b}, {l}, {d})", 0, whole_bwd=6)
        for i, what in enumerate(("K3", "K4", "K5's backward")):
            require(all(torch.equal(a, c) for a, c in zip(runs[2 * i], runs[2 * i + 1])),
                    f"{what} ({b}, {l}, {d}) causal={causal}: two launches of the split-TF32 whole-head "
                    f"backward differ")
        gaps = {"K3": gap(runs[0], (A.mha_qkv_bwd_reference(qkv, g, h, causal),)),
                "K4": gap(runs[2], A.mha_bld_bwd_reference(q, k, v, g, h, causal)),
                "K5's backward": gap(runs[4], A.attention_bwd_reference(*heads, causal)),
                "K3 against the emulation": gap(runs[0], (qkv_whole_emulation(qkv, g, h, causal),))}
        require(max(gaps.values()) <= tol, f"({b}, {l}, {d}) causal={causal}: {gaps} (tol {tol:g})")
        tf32_gap = gap((qkv_whole_emulation(qkv, g, h, causal, passes=1),),
                       (A.mha_qkv_bwd_reference(qkv, g, h, causal),))
        require(tf32_gap > tol, f"({b}, {l}, {d}): plain TF32 within {tf32_gap:.3e} of fp32, the check "
                                f"has no teeth")
        print(f"[bwd kernels] split-TF32 whole-head backward ({b}, {l}, {d}) {h} heads causal={causal}: "
              f"two launches give the same bits through K3, K4 and K5; "
              + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
              + f" of max|ref| (tol {tol:g}); plain TF32 emulated {tf32_gap:.3e}")
        del qkv, g, q, k, v, heads, runs
    torch.cuda.empty_cache()


def phase_long_bwd_kernels(report: dict) -> None:
    """K7, K9 and K10 against their plain backwards, the whole-block backward
    entries on their KV-blocked route, and the parity checks of the backward
    benchmark script."""
    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.scripts import bench_attn_bwd as bench

    limit = A.smem_limit(torch.device("cuda"))
    # at head dim 64 every case below launches a tensor-core pair: in bf16
    # mha_tc_bwd.cu's, in fp32 the split-TF32 one of mha_tf32_bwd.cu, held
    # against the emulation of its arithmetic too
    on_tensor_cores = {"tensor_cores": True, "tc_tolerance": BWD_TC_TOLERANCE}
    cases = []
    # K7 at the ViT-L/14@336px tower's shape: t = q, kv, g; the bf16 tower is
    # its path, and its fp32 numbers are the split-TF32 pair's line
    qtile_heads = lambda t: (*packed_heads(t[0], 1, 16), *packed_heads(t[1], 2, 16),  # noqa: E731
                             *packed_heads(t[2], 1, 16))
    for name, dtypes in (("mha_qtile_bwd", BF16), ("blocked_bwd_tf32", FP32)):
        cases.append(Case(
            name, (32, 577, 1024), [(32, 577, 1024), (32, 577, 2048), (32, 577, 1024)],
            lambda t: A.mha_qtile_bwd_kernel(*t, 16), lambda t: A.mha_qtile_bwd_reference(*t, 16),
            qtile_heads, kind="bwd", dtypes=dtypes, path=dtypes, relative=True,
            emulated=lambda t: A.mha_qtile_bwd_tf32x3_reference(*t, 16), **on_tensor_cores,
        ))
    # and at the ragged edges of its 64-row tiles and 64-key blocks (printed only)
    for l in (1, 63, 64, 65, 129, 1100):
        cases.append(Case(
            "mha_qtile_bwd ragged", (3, l, 128), [(3, l, 128), (3, l, 256), (3, l, 128)],
            lambda t: A.mha_qtile_bwd_kernel(*t, 2), lambda t: A.mha_qtile_bwd_reference(*t, 2),
            lambda t: (*packed_heads(t[0], 1, 2), *packed_heads(t[1], 2, 2), *packed_heads(t[2], 1, 2)),
            kind="bwd", path=(), relative=True,
            emulated=lambda t: A.mha_qtile_bwd_tf32x3_reference(*t, 2), **on_tensor_cores,
        ))

    # K9 and K10 with the log-sum-exp and the output of K8, at the fp32 tower's
    # per-head shape (its path) and ragged on both axes: t = q, k, v, g, then
    # lse and delta
    def with_stats(t, causal=False):
        out, lse = A.flash_attention_heads(t[0], t[1], t[2], save_lse=True, causal=causal)
        return [*t, lse, A.flash_delta(t[3], out)]

    # the path's shape, a ragged one, and (on no path: printed only) the mask and
    # head dim 16
    for shape, causal, path in (((512, 577, 64), False, FP32), ((8, 1100, 64), False, ()),
                                ((64, 500, 64), True, ()), ((64, 333, 16), True, ())):
        for name, kernel, plain, kind, wrt, part in (
            ("flash_dq", A.flash_dq_kernel, A.flash_dq_reference, "dq", (0,), slice(0, 1)),
            ("flash_dkv", A.flash_dkv_kernel, A.flash_dkv_reference, "dkv", (1, 2), slice(1, 3)),
        ):
            tensor_cores = shape[-1] == A.MHA_TC_HEAD_DIM
            cases.append(Case(
                name, shape, [shape] * 4,
                lambda t, f=kernel, c=causal: f(*t, c), lambda t, f=plain, c=causal: f(*t, c),
                lambda t: tuple(u[:, None] for u in t[:4]),
                prepare=lambda t, c=causal: with_stats(t, c),
                kind=kind, causal=causal, stats=2, wrt=wrt, path=path, relative=True,
                emulated=(lambda t, c=causal, p=part: A.blocked_bwd_tf32x3_reference(*t, c)[p])
                if tensor_cores else None,
                **(on_tensor_cores if tensor_cores else {}),
            ))
    # the whole-block backward entries past the whole-head kernel's shared
    # memory, on no path of the supported model (printed, not in the kernels
    # line): K3's entry at the ViT-B/16 tower's shape, K5's backward on views
    route = A.attention_bwd_route(197, 64, 4, limit)
    print(f"[long bwd] whole-block backward at L=197, dh 64: route {route!r} "
          f"(whole-head kernel {A.mha_bwd_smem_bytes(197, 64)} B, blocked pair "
          f"{A.blocked_bwd_smem_bytes(64, 4)} B, card {limit} B)")
    require(route == "blocked", f"route {route}")
    for causal in (False, True):
        cases.append(Case(
            "mha_qkv_bwd at L=197", (32, 197, 3 * 768), [(32, 197, 3 * 768), (32, 197, 768)],
            lambda t, c=causal: A.mha_qkv_bwd_kernel(*t, 12, c),
            lambda t, c=causal: A.mha_qkv_bwd_reference(*t, 12, c),
            lambda t: (*packed_heads(t[0], 3, 12), *packed_heads(t[1], 1, 12)),
            kind="bwd", causal=causal, path=(), relative=True,
            emulated=lambda t, c=causal: A.mha_qkv_bwd_tf32x3_reference(*t, 12, c), **on_tensor_cores,
        ))
    cases.append(Case(
        "fused_attention backward", (32, 12, 197, 64), (32, 197, 4, 12, 64),
        lambda t: A.fused_attention_bwd_kernel(*t.permute(2, 0, 3, 1, 4), False),
        lambda t: A.attention_bwd_reference(*t.permute(2, 0, 3, 1, 4), False),
        lambda t: tuple(t.permute(2, 0, 3, 1, 4)), kind="bwd", path=(), relative=True,
        emulated=lambda t: A.blocked_bwd_tf32x3_reference(*t.permute(2, 0, 3, 1, 4)), **on_tensor_cores,
    ))
    scratch = {}
    A.reset_launch_counts()
    run_cases("long bwd", cases, scratch, torch.Generator(device="cuda").manual_seed(SEED + 3))
    report.update({k: v for k, v in scratch.items() if k in KERNEL_SOURCE})
    # the tensor-core pair's own line: its numbers at its path's shape, K7's
    report["blocked_bwd_tc"] = dict(scratch["mha_qtile_bwd"])
    # every bf16 launch at head dim 64 took the tensor-core pair, every fp32 one
    # the split-TF32 pair; none at head dim 16
    bf16_cases, fp32_cases = (sum(c.tensor_cores and dtype in c.dtypes for c in cases)
                              for dtype in (torch.bfloat16, torch.float32))
    # K8 made each flash case's statistics once a dtype: at head dim 64 in bf16
    # on the tensor-core kernel, in fp32 on the split-TF32 one
    stats_64 = [c for c in cases if c.prepare is not None and c.shape[-1] == 64]
    tc_stats = sum(torch.bfloat16 in c.dtypes for c in stats_64)
    tf32_stats = sum(torch.float32 in c.dtypes for c in stats_64)
    require_routes("long backward kernels", tc_stats, CASE_CALLS * bf16_cases, tf32_stats,
                   CASE_CALLS * fp32_cases)
    print(f"[long bwd] {A.route_counts['blocked_bwd_tc']} launches of the tensor-core backward pair "
          f"over {bf16_cases} bf16 cases and {A.route_counts['blocked_bwd_tf32']} of the split-TF32 "
          f"pair over {fp32_cases} fp32 cases at head dim 64; none at head dim 16")

    # a fixed order of sums and no atomics: two launches give the same bits
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for dtype in BOTH:
        q, kv, g = (torch.randn(32, 577, d, device="cuda", generator=gen).to(dtype)
                    for d in (1024, 2048, 1024))
        once, again = A.mha_qtile_bwd_kernel(q, kv, g, 16), A.mha_qtile_bwd_kernel(q, kv, g, 16)
        heads = list(torch.randn(4, 64, 500, 64, device="cuda", generator=gen).to(dtype))
        out, lse = A.flash_attention_heads(*heads[:3], save_lse=True, causal=True)
        once += A.flash_bwd_kernel(*heads, lse, out, True)
        again += A.flash_bwd_kernel(*heads, lse, out, True)
        torch.cuda.synchronize()
        pair = "tensor-core" if dtype == torch.bfloat16 else "split-TF32"
        require(all(torch.equal(a, b) for a, b in zip(once, again)),
                f"two launches of the {pair} backward pair differ")
        print(f"[long bwd] K7 at (32, 577, 1024) and K9, K10 causal at (64, 500, 64), "
              f"{str(dtype).split('.')[-1]} on the {pair} pair: two launches give the same bits in "
              f"all {len(once)} gradients")
        del q, kv, g, heads, out, lse, once, again

    # autograd through fused_attention at the fp32 tower's split heads (K8, then
    # K9 and K10) against its plain path
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    packed = torch.randn(32, 577, 3, 16, 64, device="cuda", generator=gen)
    for dtype in BOTH:
        views = list(packed.to(dtype).permute(2, 0, 3, 1, 4))
        step = lambda: bench.grad_step(A.fused_attention, views)  # noqa: E731
        A.reset_launch_counts()
        got = step()
        counts = dict(A.launch_counts)
        with A.attention_impl("reference"):
            want = step()
        torch.cuda.synchronize()
        err = bench.rel_err(got, want)
        require(counts == {k: int(k in ("flash_attention_heads", "flash_dq", "flash_dkv"))
                           for k in counts}, f"fused_attention autograd launches {counts}")
        require(err <= TOLERANCE[dtype], f"fused_attention gradients {err:.3e}")
        kernel_ms, plain_ms = bench.timed_pair(step, step, 10)
        print(f"[long bwd] fused_attention forward+backward (32, 16, 577, 64) "
              f"{str(dtype).split('.')[-1]}: gradients max|err| / max|ref| {err:.3e} "
              f"(tol {TOLERANCE[dtype]:g}), kernels {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms")
        del views, got, want
    del packed
    torch.cuda.empty_cache()

    # the backward benchmark script's parity checks (fp32, 2e-5 of max|ref|; the
    # flash backward against float64)
    for label, b, l, d, h, causal in bench.SHAPES:
        err = bench.whole_block_parity(b, l, d, h, causal, "cuda")
        require(err < bench.PARITY_LIMIT, f"{label}: backward parity {err:.2e}")
        print(f"[long bwd] parity, {label} (B={b} L={l} D={d}): {err:.1e} "
              f"({A.attention_bwd_route(l, d // h, 4, limit)})")
    err = bench.qtile_parity(*bench.QTILE_SHAPE, "cuda")
    require(err < bench.PARITY_LIMIT, f"qtile backward parity {err:.2e}")
    print(f"[long bwd] parity, qtile {bench.QTILE_SHAPE}: {err:.1e}")
    flash = bench.flash_parity_f64("cuda")
    bench.check_flash_parity(flash)
    print("[long bwd] parity, flash " + str(bench.FLASH_PARITY_SHAPE) + " vs float64: "
          + ", ".join(f"{n} {ours:.2e} (plain VJP {plain:.2e})" for n, (ours, plain) in flash.items()))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def phase_small_and_causal() -> None:
    """The shapes the reference computes by its XLA formulation (head dims its
    kernels do not take, causal shapes past its whole-block kernel), here on
    kernels in both directions: each against the same call under
    ``attention_impl("reference")``, with its launches counted exactly."""
    from anomalyclip_tpu_torch.models import temporal as T
    from anomalyclip_tpu_torch.models.clip.model import attention_rung
    from anomalyclip_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)

    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=gen).requires_grad_(True)

    def both_ways(tag, fn, leaves, launches, tf32=0, bwd_tf32=0):
        """fn's value and gradients with the kernels chosen and with the plain
        versions chosen; the first run's counts must be the given ones, ``tf32``
        of its launches on the split-TF32 kernel (K8's, or K5's whole-block
        branch at head dim 64) and ``bwd_tf32`` on the split-TF32 backward
        pair."""
        def run():
            out = fn()
            return (out, *torch.autograd.grad((out.float() ** 2).sum(), leaves))

        A.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        counts = dict(A.launch_counts)
        with A.attention_impl("reference"):
            want = run()
        torch.cuda.synchronize()
        require(counts == {k: launches.get(k, 0) for k in counts}, f"{tag}: launches {counts}")
        require(dict(A.launch_counts) == counts, f"{tag}: the plain run launched a kernel")
        require_routes(tag, 0, 0, tf32, bwd_tf32)
        worst = 0.0
        for ours, theirs in zip(got, want):
            top = theirs.abs().max().item()
            require(bool(torch.isfinite(ours).all()) and top > 0, f"{tag}: not finite or all zero")
            worst = max(worst, (ours - theirs).abs().max().item() / top)
        require(worst <= TOLERANCE[torch.float32], f"{tag}: {worst:.3e} from the plain version")
        print(f"[small and causal] {tag}: launches {({k: v for k, v in counts.items() if v})}; "
              f"value and gradients within {worst:.3e} of the plain version's max "
              f"(tol {TOLERANCE[torch.float32]:g})")

    # head dim 8: the tiny temporal model (emb 32, 4 heads), forward and backward
    cfg = T.TemporalConfig(input_size=32, emb_size=32, depth=1, heads=4, dim_heads=8,
                           num_segments=4, seg_length=4)
    params = T.init_temporal_params(torch.Generator().manual_seed(SEED), cfg)
    from anomalyclip_tpu_torch.convert import tree_leaves, tree_to

    params = tree_to(params, "cuda")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    features = randn(3 * 16, 32)
    both_ways("temporal model at head dim 8", lambda: T.temporal_scores(features, params, cfg),
              [features, *leaves], {"fused_mha_bld": 2 * cfg.depth, "mha_bld_bwd": 2 * cfg.depth})
    q8 = randn(3, 2, 40, 8)
    both_ways("fused_attention at head dim 8", lambda: A.fused_attention(q8, q8, q8), [q8],
              {"fused_attention": 2})
    # head dim 16 past the whole-head backward kernel: K2 forward, the KV-blocked pair
    x16 = randn(2, 200, 3 * 32)
    require(A.attention_bwd_route(200, 16, 4, A.smem_limit(torch.device("cuda"))) == "blocked",
            "backward route at head dim 16, L=200")
    both_ways("fused_mha_bld at head dim 16, L=200",
              lambda: A.fused_mha_bld(x16[..., :32], x16[..., 32:64], x16[..., 64:], 2),
              [x16], {"fused_mha_bld": 1, "mha_bld_bwd": 1})
    # causal, L=500 at head dim 64: past the whole-block kernel; the ladder sends
    # it to the core rung, which goes on to the flash kernel with the mask
    require(attention_rung(2, 500, 256, 4, 4, True, A.smem_limit(torch.device("cuda"))) == "core",
            "rung of causal L=500")
    q, k, v = randn(2, 4, 500, 64), randn(2, 4, 500, 64), randn(2, 4, 500, 64)
    both_ways("fused_attention, causal L=500 at head dim 64",
              lambda: A.fused_attention(q, k, v, True), [q, k, v],
              {"flash_attention_heads": 1, "flash_dq": 1, "flash_dkv": 1}, tf32=1, bwd_tf32=2)
    # causal, L=197: the whole-row forward, the KV-blocked pair with the mask
    qkv = randn(2, 197, 3 * 128)
    both_ways("fused_mha_qkv, causal L=197", lambda: A.fused_mha_qkv(qkv, 2, True), [qkv],
              {"fused_mha_qkv": 1, "mha_qkv_bwd": 1}, tf32=1, bwd_tf32=1)
    q197 = randn(2, 12, 197, 64)
    both_ways("fused_attention, causal L=197", lambda: A.fused_attention(q197, q197, q197, True),
              [q197], {"fused_attention": 2}, tf32=1, bwd_tf32=1)
    torch.cuda.synchronize()


def build_ucf_model(device: str, compute_dtype: str = "float32", load_from_features: bool = False,
                    arch: str = "ViT-B/16"):
    """UCF-Crime at full width from the port's seeded init, with the ViT-B/16
    or the ViT-L/14@336px CLIP tower."""
    from anomalyclip_tpu_torch.convert import tree_to
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params
    from anomalyclip_tpu_torch.models.selector import BNState

    gen = torch.Generator().manual_seed(SEED)
    clip_cfg = {"ViT-B/16": CLIPConfig.vit_b16, "ViT-L/14@336px": CLIPConfig.vit_l14_336}[arch]()
    cfg = AnomalyCLIPConfig(
        arch=arch,
        labels_file=str(ROOT / "anomalyclip_tpu" / "labels" / "ucf_labels.csv"),
        emb_size=256, depth=1, heads=8, num_segments=32, seg_length=16,
        concat_features=False, normal_id=NORMAL_ID, stride=1, ncrops=1,
        load_from_features=load_from_features, compute_dtype=compute_dtype,
    )
    model, frozen = AnomalyCLIP.build(cfg, init_clip_params(gen, clip_cfg), clip_cfg)
    trainable, _ = model.init_trainable(gen, frozen)
    n_abn = len(model.classnames) - 1
    bn_state = BNState(
        mean=torch.randn(n_abn, generator=gen) * 0.1,
        var=torch.rand(n_abn, generator=gen) * 1.5 + 0.5,
    )
    ncentroid = torch.randn(clip_cfg.embed_dim, generator=gen) * 0.1
    return (model, tree_to(frozen, device), tree_to(trainable, device),
            bn_state.to(device), ncentroid)


def ucf_sampling() -> SimpleNamespace:
    """The sampling sizes of configs/data/ucfcrime.yaml (num_segments,
    seg_length, stride), read with the port's YAML reader: what
    ``Predictor`` samples a video by."""
    from anomalyclip_tpu_torch.config import default_config_dir, load_yaml

    data = load_yaml(default_config_dir() / "data" / "ucfcrime.yaml")
    return SimpleNamespace(**{k: int(data[k]) for k in ("num_segments", "seg_length", "stride")})


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def require_routes(what: str, tensor_core: int, bwd_tensor_core: int = 0, tf32: int = 0,
                   bwd_tf32: int = 0, bld: int = 0, bld_bwd: int = 0, whole_bwd: int = 0) -> dict:
    """The route counts of the run just made: ``tensor_core`` launches of K1, K6
    and K8 took the tensor-core kernel and ``bwd_tensor_core`` launches of the
    KV-blocked backward the tensor-core pair (all of them in bf16 at head dim
    64, none in fp32), ``tf32`` launches of K1, K6 and K8 the split-TF32 kernel
    and ``bwd_tf32`` launches of the KV-blocked backward the split-TF32 pair
    (all of them in fp32 at head dim 64, none in bf16), ``bld`` launches of K2
    and ``bld_bwd`` of K4 the split-TF32 whole-head kernels (all of them in fp32
    at head dims 16 and 32 with L <= 32), ``whole_bwd`` launches of K3, K4 and
    K5's backward the split-TF32 whole-head backward (all of them in fp32 at
    head dim 64 with L <= 112) -> the counts."""
    from anomalyclip_tpu_torch.ops.attention import route_counts

    routes = dict(route_counts)
    want = {"mha_tc": tensor_core, "blocked_bwd_tc": bwd_tensor_core, "mha_tf32": tf32,
            "blocked_bwd_tf32": bwd_tf32, "bld_tf32": bld, "bld_bwd_tf32": bld_bwd,
            "whole_bwd_tf32": whole_bwd}
    require(routes == want, f"{what}: routes {routes}, expected {want}")
    return routes


def check_video(vs, result, t_raw: int, n_abn: int) -> None:
    require(vs.scores.shape == (t_raw,), f"scores shape {vs.scores.shape}")
    require(vs.similarity.shape == (t_raw, n_abn), f"similarity shape {vs.similarity.shape}")
    require(vs.class_probs.shape == (t_raw, n_abn), f"class_probs shape {vs.class_probs.shape}")
    for name in ("scores", "similarity", "class_probs"):
        require(np.isfinite(getattr(vs, name)).all(), f"non-finite {name}")
    require(((vs.scores > 0) & (vs.scores < 1)).all(), "scores outside (0, 1)")
    require(result["num_frames"] == t_raw and len(result["frame_scores"]) == t_raw,
            "result dict length")


def assert_videos_close(a, b, atol: float, what: str) -> float:
    """|a - b| <= atol on every output -> the largest |a - b|."""
    worst = 0.0
    for name in ("scores", "similarity", "class_probs"):
        x, y = getattr(a, name), getattr(b, name)
        worst = max(worst, float(np.abs(x - y).max()))
        np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=f"{what}: {name}")
    return worst


def phase_slice() -> tuple:
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
    from anomalyclip_tpu_torch.ops.attention import (
        attention_impl,
        launch_counts,
        reset_launch_counts,
    )
    from anomalyclip_tpu_torch.predict import Predictor

    model, frozen, trainable, bn_state, ncentroid = build_ucf_model("cuda")
    n_abn = len(model.classnames) - 1
    rng = np.random.default_rng(SEED)
    videos = {t: rng.integers(0, 256, (1, t, 224, 224, 3), dtype=np.uint8) for t in VIDEO_FRAMES}
    torch.cuda.synchronize()

    # the main path: counters from zero, predictor built, three videos scored
    reset_launch_counts()
    predictor = Predictor(model, frozen, trainable, bn_state, ncentroid, device="cuda",
                          sampling=ucf_sampling())
    outputs = {}
    for t_raw, frames in videos.items():
        start = time.perf_counter()
        vs, result = predictor.score_frames(frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        check_video(vs, result, t_raw, n_abn)
        outputs[t_raw] = vs
        print(f"[slice] fp32 video {t_raw} frames: {seconds:.3f} s, {t_raw / seconds:.1f} frames/s, "
              f"max score {result['video_anomaly_score']:.4f}")
    launches = dict(launch_counts)

    # each video is padded to whole grids and encoded in calls of ENCODE_CHUNK frames;
    # the text tower runs once, when the predictor is built
    cfg, clip_cfg = model.cfg, model.clip_cfg
    grid_frames = cfg.num_segments * cfg.seg_length
    chunks = sum(-(-g * grid_frames // model.ENCODE_CHUNK) for g in VIDEO_GRIDS.values())
    require(predictor.scorer.encode_calls == chunks,
            f"encode calls {predictor.scorer.encode_calls}, expected {chunks}")
    expected = dict.fromkeys(launch_counts, 0)  # no backward; L=197 takes the mha rung
    expected.update({
        "fused_mha_qkv": clip_cfg.transformer_layers + clip_cfg.vision_layers * chunks,
        "fused_mha_bld": 2 * cfg.depth * len(VIDEO_FRAMES),
    })
    print(f"[slice] launches {launches}, expected {expected} ({chunks} encode calls)")
    require(launches == expected, f"launches {launches}, expected {expected}")
    # every K1 launch, text and image tower, at head dim 64: the split-TF32 kernel
    # and every K2 launch, the temporal model in fp32 at L=32 and 16, the
    # split-TF32 whole-head kernel
    launches.update(require_routes("fp32 scoring", 0, 0, expected["fused_mha_qkv"],
                                   bld=expected["fused_mha_bld"]))

    with attention_impl("reference"):
        ref_predictor = Predictor(model, frozen, trainable, bn_state, ncentroid, device="cuda",
                                  sampling=ucf_sampling())
        ref_vs, _ = ref_predictor.score_frames(videos[CHECK_VIDEO])
    torch.cuda.synchronize()
    err = assert_videos_close(outputs[CHECK_VIDEO], ref_vs, FP32_SLICE_TOL, "fp32 kernel vs plain")
    print(f"[slice] fp32 {CHECK_VIDEO} frames, kernels vs plain attention: max|diff| {err:.3e} "
          f"(limit {FP32_SLICE_TOL:g})")

    cfg16 = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    model16 = AnomalyCLIP(cfg16, model.clip_cfg, model.classnames, model.prompt_spec)
    # the bf16 path: counters from zero, predictor built, one video scored; every
    # K1 launch, text and image tower, takes the tensor-core kernel
    reset_launch_counts()
    pred16 = Predictor(model16, frozen, trainable, bn_state, ncentroid, device="cuda",
                       sampling=ucf_sampling())
    start = time.perf_counter()
    vs16, res16 = pred16.score_frames(videos[CHECK_VIDEO])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches16 = dict(launch_counts)
    chunks16 = -(-VIDEO_GRIDS[CHECK_VIDEO] * grid_frames // model.ENCODE_CHUNK)
    expected16 = dict.fromkeys(launch_counts, 0)
    expected16.update({
        "fused_mha_qkv": clip_cfg.transformer_layers + clip_cfg.vision_layers * chunks16,
        "fused_mha_bld": 2 * cfg.depth,
    })
    require(launches16 == expected16, f"bf16 launches {launches16}, expected {expected16}")
    # the temporal model runs in fp32 under either compute dtype
    launches16.update(require_routes("bf16 scoring", expected16["fused_mha_qkv"],
                                     bld=expected16["fused_mha_bld"]))
    print(f"[slice] bf16 launches {launches16}")
    check_video(vs16, res16, CHECK_VIDEO, n_abn)
    print(f"[slice] bf16 video {CHECK_VIDEO} frames: {seconds:.3f} s, "
          f"{CHECK_VIDEO / seconds:.1f} frames/s")
    with attention_impl("reference"):
        ref16 = Predictor(model16, frozen, trainable, bn_state, ncentroid, device="cuda",
                          sampling=ucf_sampling())
        ref16_vs, _ = ref16.score_frames(videos[CHECK_VIDEO])
    torch.cuda.synchronize()
    err16 = assert_videos_close(vs16, ref16_vs, BF16_SLICE_TOL, "bf16 kernel vs plain")
    drift = max(
        float(np.abs(getattr(vs16, n) - getattr(outputs[CHECK_VIDEO], n)).max())
        for n in ("scores", "similarity", "class_probs")
    )
    print(f"[slice] bf16 {CHECK_VIDEO} frames, kernels vs plain attention: max|diff| {err16:.3e} "
          f"(limit {BF16_SLICE_TOL:g}); bf16 vs fp32 max|diff| {drift:.3e} (not asserted)")
    torch.cuda.synchronize()
    return launches, launches16


def make_train_batches(rng: np.random.Generator, dim: int) -> list:
    """Seeded UCF-Crime batches: 32 abnormal videos with labels drawn from the 13
    abnormal classes, 32 normal ones, 512 frames of ``dim``-d features each."""
    from anomalyclip_tpu_torch.train.module import TrainBatch

    abnormal_classes = np.array([c for c in range(NUM_CLASSES) if c != NORMAL_ID])
    shape = (HALF_BATCH, FEATURE_FRAMES, dim)
    return [
        TrainBatch(
            abnormal_features=rng.standard_normal(shape, dtype=np.float32),
            abnormal_labels=rng.choice(abnormal_classes, HALF_BATCH),
            normal_features=rng.standard_normal(shape, dtype=np.float32),
            normal_labels=np.full(HALF_BATCH, NORMAL_ID),
        )
        for _ in range(TRAIN_STEPS)
    ]


class LeakyBranches:
    """The branches the temporal model's LeakyReLU (``models/temporal.py``
    ``leaky_relu``) takes in one run, recorded, and taken again in a later run.
    Its derivative jumps from 1 to 0.01 at 0, so two runs whose attention rounds
    differently (by an ulp: any kernel that is not the plain version's own
    arithmetic) take different branches wherever a pre-activation lies within
    that rounding of 0, and a conv weight's gradient jumps there by far more
    than the rounding (4.7e-4 of the leaf's max at phase 4b's step 1 with K2 and
    K4 on the split-TF32 kernels; NVIDIA H100 80GB HBM3, 700 W). A run that
    replays the other's branches computes the same function to that rounding,
    with the same derivative."""

    def __init__(self):
        from anomalyclip_tpu_torch.models import temporal

        self.temporal, self.leaky_relu = temporal, temporal.leaky_relu
        self.masks, self.taken = [], 0

    def _record(self, y, positive=None):
        self.masks.append(y >= 0)
        return self.leaky_relu(y, self.masks[-1])

    def _replay(self, y, positive=None):
        self.taken += 1
        return self.leaky_relu(y, self.masks[self.taken - 1])

    @contextlib.contextmanager
    def using(self, how):
        """``how``: "record" or "replay" within the scope."""
        self.temporal.leaky_relu = self._record if how == "record" else self._replay
        try:
            yield self
        finally:
            self.temporal.leaky_relu = self.leaky_relu


def run_training(model, frozen, trainable, bn_state, batches, ncentroid) -> SimpleNamespace:
    """TRAIN_STEPS steps through fit_steps, one step per epoch, from the given
    initial parameters -> per-step seconds and loss terms, step 1's gradients,
    how far the weights moved after each step, the final state and the
    per-epoch history."""
    from anomalyclip_tpu_torch.convert import tree_leaves
    from anomalyclip_tpu_torch.models.losses import LossConfig
    from anomalyclip_tpu_torch.train.module import build_train_step, fit_steps, init_state

    loss_cfg = LossConfig(normal_id=NORMAL_ID, num_topk=3, frames_per_segment=16, num_segments=32)
    state = init_state(trainable, bn_state, SOLVER, OPTIMIZER, SCHEDULER, steps_per_epoch=1)
    initial = tree_leaves(trainable)
    run = SimpleNamespace(seconds=[], terms=[], moved=[], grads=None)
    clock = [0.0]

    def on_step(st, terms):
        torch.cuda.synchronize()
        run.seconds.append(time.perf_counter() - clock[0])
        run.terms.append([float(t) for t in terms])
        leaves = tree_leaves(st.trainable)
        if st.step == 1:
            run.grads = [leaf.grad.detach().clone() for leaf in leaves]
        run.moved.append(max((a.detach() - b).abs().max().item() for a, b in zip(leaves, initial)))
        clock[0] = time.perf_counter()

    torch.cuda.synchronize()
    clock[0] = time.perf_counter()
    run.state, run.history = fit_steps(
        build_train_step(model, loss_cfg), frozen, state, batches, ncentroid,
        torch.Generator().manual_seed(SEED), epochs=TRAIN_STEPS, steps_per_epoch=1,
        on_step=on_step,
    )
    torch.cuda.synchronize()
    return run


def report_training(what: str, run: SimpleNamespace) -> dict:
    warm = statistics.median(run.seconds[1:])
    videos = 2 * HALF_BATCH
    print(f"[train] {what}: step seconds {', '.join(f'{t:.4f}' for t in run.seconds)}; "
          f"warm median {warm:.4f} s: {videos / warm:.1f} videos/s, "
          f"{videos * FEATURE_FRAMES / warm:.0f} feature frames/s")
    print(f"[train] {what}: losses {', '.join(f'{t[0]:.6f}' for t in run.terms)}")
    return {"step_s": run.seconds, "warm_median_s": warm}


def phase_train() -> dict:
    """The UCF-Crime training slice -> the kernel launch counts of its run."""
    from anomalyclip_tpu_torch.models.selector import BNState
    from anomalyclip_tpu_torch.ops.attention import (
        attention_impl,
        launch_counts,
        reset_launch_counts,
    )
    from anomalyclip_tpu_torch.train.module import compute_ncentroid

    model, frozen, trainable, _, _ = build_ucf_model("cuda", load_from_features=True)
    bn_state = BNState.create(len(model.classnames) - 1).to("cuda")
    dim = model.clip_cfg.embed_dim
    batches = make_train_batches(np.random.default_rng(SEED), dim)
    normal_videos = [
        SimpleNamespace(features=video[None], frame_labels=np.full(FEATURE_FRAMES, NORMAL_ID))
        for batch in batches for video in batch.normal_features
    ]
    ncentroid = torch.as_tensor(compute_ncentroid(normal_videos, dim), device="cuda")
    torch.cuda.synchronize()

    # the main path: counters from zero, three steps, counters read; the
    # temporal model's LeakyReLU branches recorded for the comparison below
    branches = LeakyBranches()
    reset_launch_counts()
    with branches.using("record"):
        run = run_training(model, frozen, trainable, bn_state, batches, ncentroid)
    launches = dict(launch_counts)
    text_layers, depth = model.clip_cfg.transformer_layers, model.cfg.depth
    per_step = {"fused_mha_qkv": text_layers, "mha_qkv_bwd": text_layers,
                "fused_mha_bld": 2 * depth, "mha_bld_bwd": 2 * depth}
    expected = {k: TRAIN_STEPS * per_step.get(k, 0) for k in launch_counts}
    print(f"[train] launches {launches}, expected {expected}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    # the text tower's backwards are whole-head (L=77, head dim 64): every one on
    # the split-TF32 whole-head backward, none on the split-TF32 pair
    launches.update(require_routes("fp32 training", 0, 0, expected["fused_mha_qkv"], 0,
                                   expected["fused_mha_bld"], expected["mha_bld_bwd"],
                                   expected["mha_qkv_bwd"]))

    require(all(np.isfinite(t).all() for t in run.terms), f"non-finite loss terms {run.terms}")
    require(run.moved[0] == 0.0, f"epoch 0 trains at lr 0, but the weights moved {run.moved[0]}")
    require(run.moved[1] > 0.0, "the weights did not move in epoch 1")
    print(f"[train] max |weight change| after each step: "
          f"{', '.join(f'{m:.3e}' for m in run.moved)}")
    timing = {"kernels": report_training("fp32 kernels", run)}

    reset_launch_counts()
    with attention_impl("reference"):
        ref = run_training(model, frozen, trainable, bn_state, batches, ncentroid)
    require(not any(launch_counts.values()), f"plain attention launched kernels: {launch_counts}")
    timing["plain"] = report_training("fp32 plain attention", ref)

    np.testing.assert_allclose(run.terms[0], ref.terms[0], rtol=TRAIN_GRAD_TOL, atol=1e-6,
                               err_msg="step 1 loss terms, kernels vs plain")
    # step 1's gradients against the plain run that takes the kernel run's
    # LeakyReLU branches (LeakyBranches); beside them, not asserted, the plain
    # run that takes its own
    free = max((got - want).abs().max().item() / want.abs().max().item()
               for got, want in zip(run.grads, ref.grads))
    reset_launch_counts()
    with attention_impl("reference"), branches.using("replay"):
        pinned = run_training(model, frozen, trainable, bn_state, batches, ncentroid)
    require(not any(launch_counts.values()), f"plain attention launched kernels: {launch_counts}")
    require(branches.taken == len(branches.masks), f"{branches.taken} of {len(branches.masks)} "
                                                   f"recorded LeakyReLU branches replayed")
    worst, differing = 0.0, 0
    for got, want in zip(run.grads, pinned.grads):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        require(scale > 0, "a trainable leaf got no gradient")
        require(err <= TRAIN_GRAD_TOL * scale,
                f"step 1 gradient: max|diff| {err:.3e} > {TRAIN_GRAD_TOL:g} x max {scale:.3e}")
        worst = max(worst, err / scale)
        differing += err > 0
    losses, ref_losses = [t[0] for t in run.terms], [t[0] for t in ref.terms]
    np.testing.assert_allclose(losses, ref_losses, rtol=TRAIN_LOSS_RTOL, atol=0,
                               err_msg="3-step losses, kernels vs plain")
    for a, b in zip(run.state.bn_state, ref.state.bn_state):
        torch.testing.assert_close(a, b, rtol=0, atol=TRAIN_BN_TOL)
    print(f"[train] kernels vs plain attention: step 1 gradients max|diff| / max|grad| "
          f"{worst:.3e} (limit {TRAIN_GRAD_TOL:g}; {differing} of {len(ref.grads)} leaves "
          f"differ at all; {free:.3e} with each run's own LeakyReLU branches, not asserted); "
          f"losses max rel diff "
          f"{max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)):.3e} "
          f"(limit {TRAIN_LOSS_RTOL:g})")
    torch.cuda.synchronize()
    return launches


def l14_video() -> np.ndarray:
    return np.random.default_rng(SEED + 2).integers(
        0, 256, (1, L14_VIDEO_FRAMES, 336, 336, 3), dtype=np.uint8
    )


def phase_l14() -> dict:
    """UCF-Crime scoring with the ViT-L/14@336px tower, fp32 then bf16 -> the
    kernel launch counts of each run."""
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
    from anomalyclip_tpu_torch.ops.attention import (
        attention_impl,
        launch_counts,
        reset_launch_counts,
    )
    from anomalyclip_tpu_torch.predict import Predictor

    start = time.perf_counter()
    model, frozen, trainable, bn_state, ncentroid = build_ucf_model("cuda", arch="ViT-L/14@336px")
    n_abn = len(model.classnames) - 1
    frames = l14_video()
    torch.cuda.synchronize()
    print(f"[l14] model and video ready: {time.perf_counter() - start:.2f} s")
    cfg, clip_cfg = model.cfg, model.clip_cfg
    chunks = -(-cfg.num_segments * cfg.seg_length // model.ENCODE_CHUNK)  # one grid
    text, vision, temporal = clip_cfg.transformer_layers, clip_cfg.vision_layers * chunks, 2 * cfg.depth
    # fp32: L=577 fits neither K1 nor K6 in fp32, so every vision layer takes the
    # core rung: fused_attention, which routes it on to the flash kernel and
    # launches no kernel of its own
    expected = {
        "float32": {"fused_mha_qkv": text, "fused_mha_bld": temporal,
                    "flash_attention_heads": vision},
        "bfloat16": {"fused_mha_qkv": text, "fused_mha_bld": temporal, "fused_mha_qtile": vision},
    }
    launches, outputs = {}, {}
    for dtype in ("float32", "bfloat16"):
        m = AnomalyCLIP(dataclasses.replace(cfg, compute_dtype=dtype), clip_cfg,
                        model.classnames, model.prompt_spec)
        # the main path: counters from zero, predictor built, the video scored
        reset_launch_counts()
        start = time.perf_counter()
        predictor = Predictor(m, frozen, trainable, bn_state, ncentroid, device="cuda",
                              sampling=ucf_sampling())
        vs, result = predictor.score_frames(frames)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches[dtype] = dict(launch_counts)
        check_video(vs, result, L14_VIDEO_FRAMES, n_abn)
        require(predictor.scorer.encode_calls == chunks,
                f"encode calls {predictor.scorer.encode_calls}, expected {chunks}")
        want = {k: expected[dtype].get(k, 0) for k in launch_counts}
        print(f"[l14] {dtype} video {L14_VIDEO_FRAMES} frames ({chunks} encode calls): "
              f"{seconds:.3f} s with the predictor's set-up, "
              f"{L14_VIDEO_FRAMES / seconds:.1f} frames/s; launches {launches[dtype]}")
        require(launches[dtype] == want, f"{dtype} launches {launches[dtype]}, expected {want}")
        launches[dtype].update(require_routes(
            f"ViT-L/14@336px {dtype} scoring", (text + vision) * (dtype == "bfloat16"), 0,
            (text + vision) * (dtype == "float32"), bld=temporal))

        start = time.perf_counter()
        with attention_impl("reference"):
            ref = Predictor(m, frozen, trainable, bn_state, ncentroid, device="cuda",
                            sampling=ucf_sampling())
            ref_vs, _ = ref.score_frames(frames)
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - start
        outputs[dtype] = vs
        gap = max(float(np.abs(getattr(vs, n) - getattr(ref_vs, n)).max())
                  for n in ("scores", "similarity", "class_probs"))
        limit = FP32_SLICE_TOL if dtype == "float32" else BF16_SLICE_TOL
        drift = "" if dtype == "float32" else "; bf16 vs fp32 max|diff| {:.3e} (not asserted)".format(
            max(float(np.abs(getattr(vs, n) - getattr(outputs["float32"], n)).max())
                for n in ("scores", "similarity", "class_probs")))
        print(f"[l14] {dtype}: plain attention {plain_seconds:.3f} s; kernels vs plain "
              f"max|diff| {gap:.3e} (limit {limit:g}){drift}")
        assert_videos_close(vs, ref_vs, limit, f"ViT-L/14@336px {dtype} kernel vs plain")
        del predictor, ref
        torch.cuda.empty_cache()

    # what catches a kernel, beside the end-to-end limit: the gap one layer's
    # kernels open, on the plain run's own input, in bf16 steps of the stream
    from anomalyclip_tpu_torch.scripts import probe_bf16_drift as drift

    res = clip_cfg.image_resolution
    tower_frames = torch.from_numpy(np.random.default_rng(SEED + 9).integers(
        0, 256, (LOCAL_GAP_FRAMES, res, res, 3), dtype=np.uint8)).to("cuda")
    reset_launch_counts()
    readings = drift.local_gap_readings(frozen["clip"], clip_cfg, tower_frames)
    torch.cuda.synchronize()
    local = {k: v for k, v in launch_counts.items() if v}
    require(len(readings) == clip_cfg.vision_layers and local == {"fused_mha_qtile": len(readings)},
            f"local gaps: {len(readings)} layers, launches {local}")
    require_routes("ViT-L/14@336px local gaps", len(readings))
    worst = max(readings, key=lambda r: r["local_steps"])
    print(f"[l14] bf16 local gap by layer, {LOCAL_GAP_FRAMES} frames, in bf16 steps of the stream: "
          + " ".join(f"{r['local_steps']:.2f}" for r in readings))
    print(f"[l14] bf16 local gap: worst at layer {worst['layer']}: {worst['local_gap']:.3e} with "
          f"max|x| {worst['stream_max']:.2f} (step {worst['step']:.3e}): {worst['local_steps']:.2f} "
          f"steps (limit {LOCAL_GAP_STEPS})")
    for r in readings:
        require(r["local_steps"] <= LOCAL_GAP_STEPS,
                f"ViT-L/14@336px bf16, layer {r['layer']}: the kernels' local gap {r['local_gap']:.3e} "
                f"is {r['local_steps']:.2f} bf16 steps of the stream (max|x| {r['stream_max']:.2f}), "
                f"limit {LOCAL_GAP_STEPS}")
    del tower_frames
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return launches


def tower_gradient_setup(arch: str):
    """Seeded CLIP weights of ``arch`` on the card, the visual tower's as leaves
    that require grad, and GRAD_BATCH seeded uint8 frames -> (config, the visual
    leaves, one forward+backward step as f(dtype) -> their gradients)."""
    from anomalyclip_tpu_torch.convert import clip_params_require_grad, tree_leaves, tree_to
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, encode_image, init_clip_params

    cfg = {"ViT-B/16": CLIPConfig.vit_b16, "ViT-L/14@336px": CLIPConfig.vit_l14_336}[arch]()
    params = init_clip_params(torch.Generator().manual_seed(SEED), cfg)
    params = clip_params_require_grad(tree_to(params, "cuda"))
    leaves = tree_leaves(params["visual"])
    res = cfg.image_resolution
    frames = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        0, 256, (GRAD_BATCH, res, res, 3), dtype=np.uint8)).to("cuda")

    def step(dtype):
        features = encode_image(params, cfg, frames, dtype)
        require(features.shape == (GRAD_BATCH, cfg.embed_dim), f"features {features.shape}")
        return torch.autograd.grad((features.float() ** 2).sum(), leaves)

    return cfg, leaves, step


def timed(fn) -> tuple:
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - start


def worst_leaf_gap(got, want) -> float:
    """max over the leaves of max|got - want| / max|want|; every gradient finite
    and not all zero."""
    worst = 0.0
    for ours, theirs in zip(got, want):
        top = theirs.abs().max().item()
        require(bool(torch.isfinite(ours).all()) and ours.shape == theirs.shape,
                "a gradient is not finite or has the wrong shape")
        require(top > 0, "a visual leaf got no gradient")
        worst = max(worst, (ours - theirs).abs().max().item() / top)
    return worst


def phase_tower_gradient() -> dict:
    """The gradient through the CLIP image tower on every rung of the ladder ->
    the kernel launch counts of each run."""
    from anomalyclip_tpu_torch.ops.attention import (
        attention_impl,
        launch_counts,
        reset_launch_counts,
    )

    # arch, dtype, limit, launches and split-TF32 backward launches per n layers
    runs = (
        ("ViT-L/14@336px", torch.bfloat16, BF16_GRAD_TOL,
         lambda n: {"fused_mha_qtile": n, "mha_qtile_bwd": n}, lambda n: 0),
        ("ViT-L/14@336px", torch.float32, FP32_GRAD_TOL,
         lambda n: {"flash_attention_heads": n, "flash_dq": n, "flash_dkv": n}, lambda n: 2 * n),
        ("ViT-B/16", torch.float32, FP32_GRAD_TOL,
         lambda n: {"fused_mha_qkv": n, "mha_qkv_bwd": n}, lambda n: n),
    )
    launches, built = {}, (None, None)
    for arch, dtype, limit, expect, on_tf32_bwd in runs:
        if built[0] != arch:
            del built
            torch.cuda.empty_cache()
            start = time.perf_counter()
            built = (arch, tower_gradient_setup(arch))
            print(f"[grad] {arch} weights and {GRAD_BATCH} frames ready: "
                  f"{time.perf_counter() - start:.2f} s")
        cfg, leaves, step = built[1]
        name = f"{arch} {str(dtype).split('.')[-1]}"
        # the main path: counters from zero, one step, counters read
        reset_launch_counts()
        got, first_s = timed(lambda: step(dtype))
        launches[name] = dict(launch_counts)
        want_counts = {k: expect(cfg.vision_layers).get(k, 0) for k in launch_counts}
        require(launches[name] == want_counts, f"{name} launches {launches[name]}, expected {want_counts}")
        # in bf16 every K6 launch and every K7 launch is a tensor-core one; in
        # fp32 every K1 and K8 launch a split-TF32 one, and every launch of K9,
        # K10 or K3's blocked route the split-TF32 pair
        on_tc = cfg.vision_layers * (dtype == torch.bfloat16)
        on_tf32 = cfg.vision_layers * (dtype == torch.float32)
        launches[name].update(require_routes(f"{name} gradient", on_tc, on_tc, on_tf32,
                                             on_tf32_bwd(cfg.vision_layers)))
        torch.cuda.reset_peak_memory_stats()
        _, warm_s = timed(lambda: step(dtype))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with attention_impl("reference"):
            want, _ = timed(lambda: step(dtype))
            again, plain_s = timed(lambda: step(dtype))
        gap = worst_leaf_gap(got, want)
        plain_gap = worst_leaf_gap(again, want)
        print(f"[grad] {name}, batch {GRAD_BATCH}, {len(leaves)} visual leaves: forward+backward "
              f"{first_s:.3f} s first, {warm_s:.3f} s warm ({GRAD_BATCH / warm_s:.1f} frames/s), "
              f"plain attention {plain_s:.3f} s warm; peak memory {peak_gb:.2f} GB; "
              f"launches {({k: v for k, v in launches[name].items() if v})}")
        print(f"[grad] {name}: kernels vs plain attention, worst leaf max|diff| / max|grad| "
              f"{gap:.3e} (limit {limit:g}); two plain passes differ by {plain_gap:.3e}")
        if name in GRAD_STEP_BEFORE:
            print(f"[grad] {name}: warm step {warm_s:.4f} s; {GRAD_STEP_BEFORE[name]}")
        require(gap <= limit, f"{name} gradients: {gap:.3e} > {limit:g}")
        del got, want, again
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return launches


def phase_probe_kernels(report: dict) -> None:
    """The probe kernels against their plain versions: the tile probe on its
    three layouts and at three tilings, twopass, pair and nosoftmax at the
    ViT-L/14@336px layer's shape, and probe_qkv_gb's four shapes."""
    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.ops import attention_probes as P
    from anomalyclip_tpu_torch.scripts.probe_qkv_gb import SHAPES as QKV_SHAPES

    d, h = 1024, 16

    def qkv_views(t):
        return t[..., :d], t[..., d:]

    def l14_case(name, l, kernel, plain, dtypes, path, **extra):
        """A case on q and k|v as views of one (32, l, 3 * 1024) projection."""
        return Case(name, (32, l, d), (32, l, 3 * d), lambda t: kernel(*qkv_views(t)),
                    lambda t: plain(*qkv_views(t)), lambda t: packed_heads(t, 3, h),
                    dtypes=dtypes, path=path, relative=True, **extra)

    cases = []
    # the tile probe on K6's layout: K6's own tiling, an even cut of 577 and more
    # warps; K and V of 577 keys fit as bf16 only, so fp32 runs at L=360, which
    # fits at 16 warps too
    for rows, warps in ((64, 8), (145, 8), (128, 16)):
        path = BF16 if (rows, warps) == (64, 8) else ()
        for l, dtypes in ((577, BF16), (360, FP32)):
            cases.append(l14_case(
                "probe_mha_qtile", l,
                lambda q, kv, r=rows, w=warps: P.probe_mha_qtile(q, kv, h, rows=r, warps=w),
                lambda q, kv: A.mha_qtile_reference(q, kv, h), dtypes, path))
            cases.append(l14_case(
                "nosoftmax_mha", l,
                lambda q, kv, r=rows, w=warps: P.nosoftmax_mha(q, kv, h, rows=r, warps=w),
                lambda q, kv: P.nosoftmax_reference(q, kv, h), dtypes, path, library=False))
    # the whole-row layout, no q tiling, K and V as fp32: the longest it runs at
    cases.append(l14_case(
        "probe_mha_whole", 400,
        lambda q, kv: P.probe_mha_whole(q, kv[..., :d], kv[..., d:], h),
        lambda q, kv: A.mha_bld_reference(q, kv[..., :d], kv[..., d:], h), BOTH, BF16))
    cases.append(l14_case(
        "twopass_mha", 577, lambda q, kv: P.twopass_mha(q, kv, h),
        lambda q, kv: P.parts_reference(q, kv, h, 2), BOTH, BF16))
    cases.append(l14_case(
        "pair_mha", 577, lambda q, kv: P.pair_mha(q, kv, h),
        lambda q, kv: P.parts_reference(q, kv, h, P.pair_parts(q)), BOTH, BF16))
    # the packed layout at probe_qkv_gb's shapes, K1's own tiling and another
    for b, l, width, heads, causal in QKV_SHAPES.values():
        for rows, warps, stage_fp32 in ((64, 8, True), (128, 16, False)):
            cases.append(Case(
                "probe_mha_qkv", (b, l, 3 * width), (b, l, 3 * width),
                lambda t, n=heads, c=causal, r=rows, w=warps, f=stage_fp32: P.probe_mha_qkv(
                    t, n, c, rows=r, warps=w, stage_fp32=f),
                lambda t, n=heads, c=causal: A.mha_qkv_reference(t, n, c),
                lambda t, n=heads: packed_heads(t, 3, n), causal=causal,
                path=BF16 if stage_fp32 else (), relative=True,
            ))
    scratch = {}
    run_cases("probe kernels", cases, scratch, torch.Generator(device="cuda").manual_seed(SEED + 6))
    report.update({k: v for k, v in scratch.items() if k in PROBE_REPLACES})

    # the one failure that is a probe's result: K and V of 577 keys as fp32 do
    # not fit a block, and the wrapper says so with the sizes before any launch
    q = torch.zeros(1, 577, 3 * d, device="cuda", dtype=torch.bfloat16)
    P.reset_launch_counts()
    try:
        P.probe_mha_whole(q[..., :d], q[..., d:2 * d], q[..., 2 * d:], h)
    except P.ProbeDoesNotFit as exc:
        print(f"[probe kernels] whole at L=577 with fp32 staging: raises: {exc}")
        require(exc.need == A.mha_smem_bytes(577, 64) and not any(P.launch_counts.values()),
                f"refusal sizes {exc.need}, launches {P.launch_counts}")
    else:
        raise AssertionError("whole at L=577 with fp32 staging did not raise")
    for what, blocks in (
        ("K6's tiling", P.probe_blocks_per_sm(torch.bfloat16, 577, 8, False)),
        ("twopass", P.parts_blocks_per_sm(torch.bfloat16, 64, P.kv_part_length(577, 2), 8, 1)),
        ("pair", P.parts_blocks_per_sm(torch.bfloat16, 64, P.kv_part_length(577, 2), 8, 2)),
    ):
        print(f"[probe kernels] blocks one SM holds at L=577 in bf16, {what}: {blocks}")
    torch.cuda.synchronize()


@contextlib.contextmanager
def silent_profiler_sessions():
    """While open, every torch.profiler session that records no device time
    and is run again books the launches made inside it -> the Counter of those
    launches. ``_bench_util.device_ms`` runs such a session again (the profiler
    now and then hands one back empty), up to its last session, after which it
    gives up (``device_readings["not_measured"]``): so a script that times by
    device time launches one session's calls more than its own count says for
    each session run again, and none for the last one of a reading given up.
    Those launches are measured here, not assumed."""
    import collections

    import torch.profiler

    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.scripts import _bench_util

    real, booked = torch.profiler.profile, collections.Counter()
    silent = []  # the last silent session's launches, and the readings given up when it ended

    def counts():
        return collections.Counter({**A.launch_counts, **A.route_counts})

    def settle():
        """The silent session before this point was run again unless its
        reading was given up since it ended."""
        if silent:
            launches, given_up = silent.pop()
            if _bench_util.device_readings["not_measured"] == given_up:
                booked.update(launches)

    class Profile(real):
        def __enter__(self):
            settle()
            self.launches_before = counts()
            return super().__enter__()

        def __exit__(self, *exc):
            done = super().__exit__(*exc)
            cuda = torch.autograd.DeviceType.CUDA
            if sum(e.time_range.elapsed_us() for e in self.events() if e.device_type == cuda) <= 0:
                silent.append((counts() - self.launches_before, _bench_util.device_readings["not_measured"]))
            return done

    torch.profiler.profile = Profile
    try:
        yield booked
    finally:
        settle()
        torch.profiler.profile = real


def run_script(name: str, argv: list, expected: dict) -> dict:
    """One script of the port through its ``main``, the launch counts set to 0
    just before and read just after -> the counts, which must be ``expected``
    (entries not named: 0), beside the launches of any profiler session that
    recorded no device time and was run again (``silent_profiler_sessions``)."""
    import importlib

    from anomalyclip_tpu_torch.ops import attention as A
    from anomalyclip_tpu_torch.ops import attention_probes as P

    module = importlib.import_module(f"anomalyclip_tpu_torch.scripts.{name}")
    print(f"[scripts] {name} {' '.join(argv)}", flush=True)
    A.reset_launch_counts()
    P.reset_launch_counts()
    start = time.perf_counter()
    with silent_profiler_sessions() as repeated:
        try:
            module.main(argv)
        except SystemExit as exc:  # the validate scripts exit with their verdict
            require(exc.code in (0, None), f"{name} exited with {exc.code}")
        torch.cuda.synchronize()
    counts = {**A.launch_counts, **A.route_counts, **P.launch_counts}
    want = {k: expected.get(k, 0) + repeated[k] for k in counts}
    print(f"[scripts] {name}: {time.perf_counter() - start:.1f} s, launches "
          f"{({k: v for k, v in counts.items() if v})}", flush=True)
    if repeated:
        print(f"[scripts] {name}: launches in profiler sessions that recorded no device time and "
              f"were run again: {dict(repeated)}", flush=True)
    require(counts == want, f"{name} launches {counts}, expected {want}")
    torch.cuda.empty_cache()
    return counts


def phase_scripts() -> list:
    """The probe and measurement scripts on the card -> the launch counts of
    each run. A function a script checks and times is called once, once more
    to warm and ``--iters`` times. The scripts that run in bf16 launch the
    tensor-core kernel for every K1, K6 and K8 call at head dim 64 ("mha_tc")."""
    n = SCRIPT_ITERS
    calls = n + 2
    it = ["--iters", str(n)]
    from anomalyclip_tpu_torch.scripts import _bench_util

    readings = dict(_bench_util.device_readings)
    runs = []
    # the isolated variants at the ViT-L/14@336px layer's shape and its aligned
    # neighbour, then the two that need a length whose K and V fit otherwise
    defaults = {"fused_mha_qtile": calls, "mha_tc": calls, "probe_mha_qtile": calls,
                "twopass_mha": calls, "nosoftmax_mha": calls}
    runs.append(run_script("bench_attn_l14", ["--check", *it], defaults))
    runs.append(run_script("bench_attn_l14", ["--check", "--seq", "576", *it], defaults))
    runs.append(run_script("bench_attn_l14", ["--check", "--seq", "400", "--variants", "whole,pair", *it],
                           {"probe_mha_whole": calls, "pair_mha": calls}))
    runs.append(run_script("probe_qkv_gb", ["b16", "bf16", "64,8", "128,16", "64,8,op", *it],
                           {"probe_mha_qkv": 3 * calls}))
    runs.append(run_script("probe_qkv_gb", ["text", "bf16", "64,8", *it], {"probe_mha_qkv": calls}))
    runs.append(run_script("probe_qtile_vmem", ["145,8", "128,16", *it], {"probe_mha_qtile": 2 * calls}))
    # the whole tower: --iters 15 gives 5 timed forwards after a checked and a
    # warm one; 24 layers each under the fused kernels, no launch under the
    # identity and the plain attention
    runs.append(run_script("bench_attn_l14", ["--tower", "--iters", "15"],
                           {"fused_mha_qtile": 24 * 7, "mha_tc": 24 * 7}))
    # K1 at its five shapes and K6 past its envelope (the refused call launches
    # nothing); K6 once and K8 three times in the checks, then both timed
    runs.append(run_script("validate_pickgb", it, {"fused_mha_qkv": 5 * calls, "fused_mha_qtile": calls,
                                                   "mha_tc": 6 * calls}))
    # K6 once and K8 three times (the core rung at L=1024, 1024 and 1536) in the
    # checks, then both timed: all in bf16 at head dim 64 on the tensor-core kernel
    runs.append(run_script("validate_qtile_config", it,
                           {"fused_mha_qtile": 1 + (n + 1), "flash_attention_heads": 3 + (n + 1),
                            "mha_tc": 1 + (n + 1) + 3 + (n + 1)}))
    # the tensor-core kernel at the towers' seven shapes (four through K1, two
    # through K6, one through K8), each checked, warmed and timed, with the
    # opcode mixes of its two instantiations read from the built library, and
    # the backward pair at the four of them past the whole-head backward (two
    # through K3's entry, two through K7), with both its kernels' opcode mixes;
    # then the split-TF32 kernel in fp32 at six shapes (three through K1, two
    # through K8, one through K6), and its opcode mix; then the split-TF32
    # backward pair at three (K9 and K10 on the gradient's heads after one K8
    # launch for their statistics, K7, K3's entry), and both its kernels' mixes;
    # then K2 and K4 at the temporal model's four shapes on the split-TF32
    # whole-head kernels, each checked once and timed by three clocks (a warm
    # call and --iters calls under the profiler and by events, a warm call and
    # HOST_CALLS enqueues on the host clock), and K2's host time split into its
    # parts, the entry and the wrapper each warmed and enqueued HOST_CALLS times
    # (the library called alone counts nothing)
    # (the library called alone counts nothing); then K1 and K3 at the two text
    # towers' shapes in fp32, each checked once and timed by the three clocks,
    # K3 on the split-TF32 whole-head backward; then K5's whole-block branch at
    # (256, 12, 197, 64) in fp32 and bf16, causal and not, each checked once
    # and timed by device and event time, on the split-TF32 kernel in fp32 and
    # the tensor-core one in bf16
    from anomalyclip_tpu_torch.scripts.bench_mha_tc import (
        BLD_SHAPES,
        HOST_CALLS,
        TEXT_SHAPES,
        WHOLE_BLOCK_CASES,
    )

    bld = len(BLD_SHAPES) * (1 + 2 * (1 + n) + 1 + HOST_CALLS)
    k2 = bld + 2 * (1 + HOST_CALLS)
    text = len(TEXT_SHAPES) * (1 + 2 * (1 + n) + 1 + HOST_CALLS)
    whole_block = {dtype: sum(d == dtype for d, _ in WHOLE_BLOCK_CASES) * (1 + 2 * (1 + n)) for dtype in BOTH}
    runs.append(run_script("bench_mha_tc", ["--sass", *it], {
        "fused_mha_qkv": (4 + 3) * calls + text, "fused_mha_qtile": (2 + 1) * calls,
        "mha_tc": 7 * calls + whole_block[torch.bfloat16],
        "mha_qkv_bwd": (2 + 1) * calls + text, "mha_qtile_bwd": (2 + 1) * calls, "blocked_bwd_tc": 4 * calls,
        "flash_attention_heads": (1 + 2) * calls + 1,
        "mha_tf32": 6 * calls + 1 + text + whole_block[torch.float32],
        "flash_dq": calls, "flash_dkv": calls, "blocked_bwd_tf32": (2 + 1 + 1) * calls,
        "fused_mha_bld": k2, "mha_bld_bwd": bld, "bld_tf32": k2, "bld_bwd_tf32": bld,
        "whole_bwd_tf32": text, "fused_attention": sum(whole_block.values())}))
    # K7's parity in fp32 (one launch of the split-TF32 pair), then the bf16
    # forward+backward step, warmed and timed, on the tensor-core kernels
    runs.append(run_script("bench_attn_bwd", ["--qtile", *it], {
        "fused_mha_qtile": n + 1, "mha_tc": n + 1, "mha_qtile_bwd": 1 + n + 1,
        "blocked_bwd_tc": n + 1, "blocked_bwd_tf32": 1}))
    # the ViT-L/14@336px tower by layer under the kernels and three plain forms:
    # 24 K6 launches along the kernel run and 24 for its local gaps
    runs.append(run_script("probe_bf16_drift", ["--seeds", "1", "--frames", "8"],
                           {"fused_mha_qtile": 48, "mha_tc": 48}))
    # the int8 tower by layer: its kernel run and the fp tower under the
    # kernels, the plain run, the nudged run and the local gaps under the plain
    # attention (ViT-B/16 fp32: 12 K1 a tower; ViT-L/14@336px bf16: 24 K6)
    runs.append(run_script("probe_int8_drift", ["--frames", "32"], {"fused_mha_qkv": 24, "mha_tf32": 24}))
    runs.append(run_script("probe_int8_drift", ["--arch", "l14@336", "--dtype", "bf16", "--frames", "8"],
                           {"fused_mha_qtile": 48, "mha_tc": 48}))
    # 12 text layers when the scorer is built; two axial attentions a scoring call
    # (emb 128: head dim 16, on the split-TF32 whole-head kernel)
    runs.append(run_script("bench_eval", it, {"fused_mha_qkv": 12, "mha_tf32": 12,
                                              "fused_mha_bld": 2 * calls, "bld_tf32": 2 * calls}))
    # features: four sizes; frames: 512 and 1024 frames in encode calls of 256
    # through the 12 vision layers, timed over max(4, iters // 4) calls
    frame_calls = 2 + max(4, n // 4)
    runs.append(run_script("bench_latency", ["--path", "both", *it], {
        "fused_mha_qkv": 12 + frame_calls * 12 * (2 + 4),
        "mha_tc": 12 + frame_calls * 12 * (2 + 4),
        "fused_mha_bld": 2 * (4 * calls + 2 * frame_calls),
        "bld_tf32": 2 * (4 * calls + 2 * frame_calls),
    }))
    # a first step and four timed ones: 2048 frames in 8 encode calls, the text
    # tower forward and backward, the temporal model's two axes each way
    steps = 5
    runs.append(run_script("bench_train_step", [], {
        "fused_mha_qkv": steps * (8 * 12 + 12), "mha_tc": steps * (8 * 12 + 12),
        "mha_qkv_bwd": steps * 12,
        "fused_mha_bld": steps * 2, "mha_bld_bwd": steps * 2,
        "bld_tf32": steps * 2, "bld_bwd_tf32": steps * 2,
    }))
    # the device times that no profiler session recorded print as "not
    # measured": their count, beside that of the measured ones
    counted = {k: n - readings[k] for k, n in _bench_util.device_readings.items()}
    print(f"[scripts] device times by torch.profiler: {counted['measured']} measured, "
          f"{counted['not_measured']} not measured", flush=True)
    return runs


def epochs_of(loader, first: int, epochs: int, kept: list, waits: list):
    """The batches of ``loader``'s epochs ``first``, ``first + 1``, ...
    (``epochs`` of them), each epoch begun through ``set_epoch``; each batch is
    appended to ``kept``, and the host seconds its consumer waited for it to
    ``waits`` (an epoch's first wait includes the start of its prefetch)."""
    for epoch in range(first, first + epochs):
        loader.set_epoch(epoch)
        clock = time.perf_counter()
        for batch in loader:
            waits.append(time.perf_counter() - clock)
            kept.append(batch)
            yield batch
            clock = time.perf_counter()


def leaf_paths(tree, prefix: str = "") -> list:
    """The keys down to each tensor of a tree of dictionaries and lists, joined
    by "/", in the order ``tree_leaves`` gives the tensors."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def by_epoch_position(seconds: list, per_epoch: int) -> tuple:
    """Seconds per batch or step over whole epochs -> (those of each epoch's
    first, the median of the others, their least, their most)."""
    rest = [s for i, s in enumerate(seconds) if i % per_epoch]
    return seconds[::per_epoch], statistics.median(rest), min(rest), max(rest)


def annotated_frame_labels(annotations: Path) -> np.ndarray:
    """The per-frame labels of the test set straight from the generator's two
    annotation files: the video's class inside its annotated span, the normal
    class elsewhere, in the order of the test list."""
    spans = {}
    for line in (annotations / TEMPORAL_ANNOTATIONS).read_text().splitlines():
        if line.strip():
            name, _, start, end = line.split()
            spans[name] = (int(start), int(end))
    labels = []
    for line in (annotations / "Anomaly_Test.txt").read_text().splitlines():
        if line.strip():
            name, first, last, label = line.split()
            frames = np.arange(int(first), int(last) + 1)
            start, end = spans[name]
            labels.append(np.where((frames >= start) & (frames <= end), int(label), NORMAL_ID))
    return np.concatenate(labels)


def make_feature_set(root: Path) -> tuple:
    """The port's synthetic generator writes FEATURE_SET at UCF-Crime's width
    under ``root`` -> (its features directory, its annotations directory)."""
    from anomalyclip_tpu_torch.data.synthetic import generate_synthetic_dataset

    frames_root, annotations = root / "features", root / "annotations"
    start = time.perf_counter()
    generate_synthetic_dataset(frames_root, annotations, num_classes=NUM_CLASSES, normal_id=NORMAL_ID,
                               feature_dim=FEATURE_DIM, seed=SEED, make_frames=False, **FEATURE_SET)
    size = sum(f.stat().st_size for f in frames_root.iterdir())
    print(f"[data] feature set: {size / 1e9:.3f} GB of .npy in {time.perf_counter() - start:.1f} s",
          flush=True)
    return frames_root, annotations


def phase_data(smi: str, frames_root: Path, annotations: Path) -> dict:
    """The UCF-Crime model from a feature set on disk: the port's datamodule
    and loaders over the set ``make_feature_set`` wrote, the loader timed alone,
    ncentroid, two epochs of training resumed at epoch DATA_START_EPOCH,
    ``GridScorer.update`` with the trained state, whole-set evaluation and the
    detection metrics -> the kernel launch counts of that run."""
    from anomalyclip_tpu_torch.convert import tree_leaves, tree_map
    from anomalyclip_tpu_torch.data import AnomalyCLIPDataModule, DataConfig
    from anomalyclip_tpu_torch.eval.evaluator import GridScorer, evaluate_videos
    from anomalyclip_tpu_torch.eval.grids import DEFAULT_BUCKETS, bucket_size
    from anomalyclip_tpu_torch.eval.metrics import detection_metrics
    from anomalyclip_tpu_torch.models.losses import LossConfig
    from anomalyclip_tpu_torch.models.selector import BNState
    from anomalyclip_tpu_torch.ops.attention import (
        attention_impl,
        launch_counts,
        reset_launch_counts,
        route_counts,
    )
    from anomalyclip_tpu_torch.train.module import build_train_step, compute_ncentroid, fit_steps, init_state

    model, frozen, trainable, _, _ = build_ucf_model("cuda", load_from_features=True)
    bn_state = BNState.create(len(model.classnames) - 1).to("cuda")
    dim = model.clip_cfg.embed_dim
    require(dim == FEATURE_DIM, f"embed dim {dim}")
    train_step = build_train_step(model, LossConfig(normal_id=NORMAL_ID, num_topk=3, frames_per_segment=16,
                                                    num_segments=32))
    cfg = DataConfig(
        annotation_file_normal=str(annotations / "Anomaly_Train_Normal.txt"),
        annotation_file_anomaly=str(annotations / "Anomaly_Train_Abnormal.txt"),
        annotation_file_test=str(annotations / "Anomaly_Test.txt"),
        annotation_file_temporal_test=str(annotations / TEMPORAL_ANNOTATIONS),
        frames_root=str(frames_root),
        labels_file=str(ROOT / "anomalyclip_tpu" / "labels" / "ucf_labels.csv"),
        normal_id=NORMAL_ID, num_classes=NUM_CLASSES, num_segments=32, seg_length=16,
        batch_size=2 * HALF_BATCH, num_workers=8, load_from_features=True,
    )
    dm = AnomalyCLIPDataModule(cfg, seed=SEED)

    # the loader alone, from disk (the files were just written: the page
    # cache holds them), over LOADER_EPOCHS epochs
    loader = dm.train_dataloader()
    per_epoch = len(loader)
    require(per_epoch == FEATURE_SET["num_abnormal"] // HALF_BATCH, f"{per_epoch} batches an epoch")
    alone, alone_waits = [], []
    start = time.perf_counter()
    for _ in epochs_of(loader, DATA_START_EPOCH, LOADER_EPOCHS, alone, alone_waits):
        pass
    seconds = time.perf_counter() - start
    loader.close()
    require(len(alone) == LOADER_EPOCHS * per_epoch, f"{len(alone)} batches in {LOADER_EPOCHS} epochs")
    firsts, median, low, high = by_epoch_position(alone_waits, per_epoch)
    print(f"[data] loader alone from disk: {len(alone)} batches of {2 * HALF_BATCH} videos, {LOADER_EPOCHS} "
          f"epochs of {per_epoch}, in {seconds:.3f} s; each epoch's first batch "
          f"{', '.join(f'{s:.4f}' for s in firsts)} s; the other {len(alone) - len(firsts)}: median "
          f"{median:.4f} s ({low:.4f}-{high:.4f}), {1 / median:.2f} batches/s ({smi})", flush=True)

    def resumed_state():
        """The initial state resumed at the start of epoch DATA_START_EPOCH:
        the schedule's update count at that epoch's first step."""
        state = init_state(trainable, bn_state, SOLVER, OPTIMIZER, SCHEDULER, steps_per_epoch=per_epoch)
        state.optimizer.count = DATA_START_EPOCH * per_epoch
        return state

    def train(attention: str, steps: int, keep_starts: bool) -> SimpleNamespace:
        """``steps`` steps of fit_steps over the train loader from the
        resumed state -> the run: per-step seconds, the loader waits in
        them, loss terms, gradients, batches, the final state and, with
        ``keep_starts``, the state each step started from (trainable
        leaves, BN state, the dropout generator's state)."""
        loader, gen = dm.train_dataloader(), torch.Generator().manual_seed(SEED)
        run = SimpleNamespace(seconds=[], waits=[], terms=[], grads=[], batches=[],
                              starts=[(trainable, bn_state, gen.get_state())])
        clock = [0.0]

        def on_step(st, step_terms):
            torch.cuda.synchronize()
            run.seconds.append(time.perf_counter() - clock[0])
            run.terms.append([float(x) for x in step_terms])
            run.grads.append([leaf.grad.detach().clone() for leaf in tree_leaves(st.trainable)])
            if keep_starts:
                run.starts.append((tree_map(lambda t: t.detach().clone(), st.trainable),
                                   BNState(*(t.clone() for t in st.bn_state)), gen.get_state()))
            clock[0] = time.perf_counter()

        epochs = -(-steps // per_epoch)
        stream = epochs_of(loader, DATA_START_EPOCH, epochs, run.batches, run.waits)
        with attention_impl(attention):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
            run.state, history = fit_steps(train_step, frozen, resumed_state(), stream, ncentroid, gen,
                                           epochs=epochs, steps_per_epoch=min(steps, per_epoch),
                                           on_step=on_step)
        stream.close()
        loader.close()
        require(run.state.step == steps and len(history) == epochs and len(run.batches) == steps,
                f"{run.state.step} steps in {len(history)} epochs, expected {steps} in {epochs}")
        return run

    def evaluate(scorer, attention: str):
        videos = []
        with attention_impl(attention):
            torch.cuda.synchronize()
            start = time.perf_counter()
            ev = evaluate_videos(dm.test_dataloader(), scorer, model, on_video=videos.append)
            torch.cuda.synchronize()
        return ev, videos, time.perf_counter() - start

    # the main path: counters from zero; ncentroid, the scorer, two epochs
    # of training, the scorer updated with the trained state, the whole
    # test set scored; the temporal model's LeakyReLU branches recorded for
    # the gradient check below
    steps = DATA_EPOCHS * per_epoch
    branches = LeakyBranches()
    reset_launch_counts()
    ncentroid = torch.as_tensor(compute_ncentroid(dm.train_dataloader_test_mode(), dim), device="cuda")
    scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device="cuda")
    with branches.using("record"):
        run = train("kernel", steps, keep_starts=True)
    scorer.update(frozen, run.state.trainable, run.state.bn_state, ncentroid)
    ev, videos, eval_seconds = evaluate(scorer, "kernel")
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    text_layers, depth = model.clip_cfg.transformer_layers, model.cfg.depth
    # the text tower: the scorer's constructor, each step, the update
    expected = dict.fromkeys(launch_counts, 0)
    expected.update({"fused_mha_qkv": (steps + 2) * text_layers,
                     "mha_qkv_bwd": steps * text_layers,
                     "fused_mha_bld": 2 * depth * (steps + len(videos)),
                     "mha_bld_bwd": 2 * depth * steps})
    print(f"[data] launches {launches}, expected {expected}")
    require(launches == expected, f"launches {launches}, expected {expected}")
    launches.update(require_routes("fp32 data and evaluation", 0, 0, expected["fused_mha_qkv"], 0,
                                   expected["fused_mha_bld"], expected["mha_bld_bwd"],
                                   expected["mha_qkv_bwd"]))

    # what came out: the labels of the annotations, finite scores of the set's
    # length, the grid buckets 1, 2 and 4 all filled
    labels = annotated_frame_labels(annotations)
    n_abn = NUM_CLASSES - 1
    np.testing.assert_array_equal(ev["labels"], labels, err_msg="evaluated labels vs the annotations")
    require(ev["abnormal_scores"].shape == labels.shape and ev["class_probs"].shape == (len(labels), n_abn),
            f"shapes {ev['abnormal_scores'].shape} {ev['class_probs'].shape} for {len(labels)} frames")
    require(np.isfinite(ev["abnormal_scores"]).all() and np.isfinite(ev["class_probs"]).all(),
            "non-finite scores")
    grids = sorted({-(-len(vs.scores) // (32 * 16)) for vs in videos})
    buckets = sorted({bucket_size(g, DEFAULT_BUCKETS) for g in grids})
    require(buckets == [1, 2, 4], f"the test set's grids {grids} fill buckets {buckets}, not 1, 2 and 4")
    binary = labels != NORMAL_ID
    require(binary.any() and not binary.all(), "the test set holds one class only")
    det = detection_metrics(ev["abnormal_scores"], ev["labels"], ev["class_probs"], NORMAL_ID, NUM_CLASSES)
    metrics = np.array([det[k] for k in EVAL_METRICS])
    require(np.isfinite(metrics).all(), f"non-finite metrics {dict(zip(EVAL_METRICS, metrics))}")
    require(all(np.isfinite(terms_).all() for terms_ in run.terms), f"non-finite loss terms {run.terms}")
    firsts, median, low, high = by_epoch_position(run.seconds, per_epoch)
    wait_firsts, wait_median, _, _ = by_epoch_position(run.waits, per_epoch)
    print(f"[data] training with the loader, {steps} steps over {DATA_EPOCHS} epochs of {per_epoch}: each "
          f"epoch's first step {', '.join(f'{s:.4f}' for s in firsts)} s (waiting for the loader "
          f"{', '.join(f'{s:.4f}' for s in wait_firsts)}); the other {steps - len(firsts)}: median "
          f"{median:.4f} s ({low:.4f}-{high:.4f}), of which waiting for the loader {wait_median:.4f} s "
          f"({smi})")
    frames = len(labels)
    print(f"[data] evaluation, one pass over {len(videos)} videos, {frames} frames: {eval_seconds:.3f} s, "
          f"{eval_seconds / len(videos):.4f} s/video, {frames / eval_seconds:.0f} frames/s ({smi})")
    print(f"[data] metrics after {steps} steps: "
          + ", ".join(f"{k} {v:.6f}" for k, v in zip(EVAL_METRICS, metrics)) + f" ({smi})")

    # the same under the plain attention: DATA_CHECK_STEPS steps from the
    # same state on its own loader; every step of the kernel run again from
    # the state it started from, taking its LeakyReLU branches; the kernel
    # run's trained state evaluated
    reset_launch_counts()
    ref = train("reference", DATA_CHECK_STEPS, keep_starts=False)
    gaps, names = [], leaf_paths(trainable)
    with attention_impl("reference"), branches.using("replay"):
        for step, ((params, bn, gen_state), batch, grads) in enumerate(
                zip(run.starts[:-1], run.batches, run.grads, strict=True), 1):
            gen, want = torch.Generator(), []
            gen.set_state(gen_state)
            fit_steps(train_step, frozen, init_state(params, bn, SOLVER, OPTIMIZER, SCHEDULER, per_epoch),
                      [batch], ncentroid, gen, epochs=1, steps_per_epoch=1,
                      on_step=lambda st, _: want.extend(leaf.grad.detach().clone()
                                                        for leaf in tree_leaves(st.trainable)))
            for name, got, pinned in zip(names, grads, want, strict=True):
                scale = pinned.abs().max().item()
                err = (got - pinned).abs().max().item()
                require(scale > 0, f"{name} got no gradient in step {step}")
                require(err <= TRAIN_GRAD_TOL * scale, f"step {step} gradient of {name}: max|diff| "
                                                       f"{err:.3e} > {TRAIN_GRAD_TOL:g} x max {scale:.3e}")
                gaps.append((err / scale, step, name))
    require(branches.taken == len(branches.masks), f"{branches.taken} of {len(branches.masks)} "
                                                   f"recorded LeakyReLU branches replayed")
    with attention_impl("reference"):
        ref_scorer = GridScorer(model, frozen, run.state.trainable, run.state.bn_state, ncentroid, device="cuda")
    ref_ev, _, _ = evaluate(ref_scorer, "reference")
    require(not any(launch_counts.values()) and not any(route_counts.values()),
            f"plain attention launched kernels: {launch_counts} {route_counts}")
    # the loader's batches to the bit: the loader alone over the same epochs,
    # and the plain run's own loader
    for what, got, want in (("the loader alone", alone[:steps], run.batches),
                            ("the plain run", ref.batches, run.batches[:DATA_CHECK_STEPS])):
        for batch, other in zip(got, want, strict=True):
            for name in batch._fields:
                np.testing.assert_array_equal(getattr(batch, name), getattr(other, name),
                                              err_msg=f"loader batch {name}, {what} vs the kernel run")
    # every step updated every leaf: the schedule's lr is above 0 from the first
    for step, (before, after) in enumerate(zip(run.starts, run.starts[1:]), 1):
        moved = min((a - b).abs().max().item() for a, b in zip(tree_leaves(after[0]), tree_leaves(before[0])))
        require(moved > 0, f"a trainable leaf did not move in step {step}")
    np.testing.assert_allclose(run.terms[0], ref.terms[0], rtol=TRAIN_GRAD_TOL, atol=1e-6,
                               err_msg="step 1 loss terms, kernels vs plain")
    losses, ref_losses = [t[0] for t in run.terms[:DATA_CHECK_STEPS]], [t[0] for t in ref.terms]
    np.testing.assert_allclose(losses, ref_losses, rtol=TRAIN_LOSS_RTOL, atol=0,
                               err_msg=f"{DATA_CHECK_STEPS}-step losses, kernels vs plain")
    trained, trained_bn = run.starts[DATA_CHECK_STEPS][:2]
    for a, b in zip(trained_bn, ref.state.bn_state):
        torch.testing.assert_close(a, b, rtol=0, atol=TRAIN_BN_TOL)
    # not asserted: the two runs' weights after DATA_CHECK_STEPS steps, each
    # leaf's gap over its largest change. AdamW's first updates are about lr
    # times the sign of each gradient element, so an element whose gradient
    # lies within a rounding of 0 may move either way: the gradients above are
    # what holds the backward kernels
    weight_gap = max(((a - b).abs().max() / (b - c).abs().max()).item() for a, b, c in
                     zip(tree_leaves(trained), tree_leaves(ref.state.trainable), tree_leaves(trainable)))
    np.testing.assert_array_equal(ref_ev["labels"], ev["labels"])
    for name in ("abnormal_scores", "class_probs"):
        np.testing.assert_allclose(ev[name], ref_ev[name], rtol=0, atol=FP32_SLICE_TOL,
                                   err_msg=f"evaluated {name}, kernels vs plain")
    ref_det = detection_metrics(ref_ev["abnormal_scores"], ref_ev["labels"], ref_ev["class_probs"],
                                NORMAL_ID, NUM_CLASSES)
    ref_metrics = np.array([ref_det[k] for k in EVAL_METRICS])
    np.testing.assert_allclose(metrics[:4], ref_metrics[:4], rtol=0, atol=EVAL_METRIC_TOL,
                               err_msg="AUC, AP, mAUC, mAP, kernels vs plain")
    gaps.sort(reverse=True)
    print(f"[data] kernels vs plain attention: gradients of all {steps} steps from the kernel run's own states, "
          f"max|diff| / max|grad| {gaps[0][0]:.3e} (limit {TRAIN_GRAD_TOL:g}; the largest: "
          + ", ".join(f"{gap:.3e} step {step} {name}" for gap, step, name in gaps[:3])
          + f"; median over {len(gaps)} {statistics.median(g for g, _, _ in gaps):.3e}); {DATA_CHECK_STEPS}-step losses max "
          f"rel diff {max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)):.3e} (limit "
          f"{TRAIN_LOSS_RTOL:g}); weights after {DATA_CHECK_STEPS} steps, max|diff| / max|change| "
          f"{weight_gap:.3e} (not asserted); scores max|diff| "
          f"{np.abs(ev['abnormal_scores'] - ref_ev['abnormal_scores']).max():.3e}, class probs "
          f"{np.abs(ev['class_probs'] - ref_ev['class_probs']).max():.3e} (limit {FP32_SLICE_TOL:g}); metrics "
          f"max|diff| {np.abs(metrics[:4] - ref_metrics[:4]).max():.3e} (limit {EVAL_METRIC_TOL:g}); loader "
          f"batches equal to the bit")
    torch.cuda.synchronize()
    return launches


def ucf_fit_config(frames_root: Path, annotations: Path, save_dir: Path) -> dict:
    """The UCF-Crime training run of ``configs/experiment/ucfcrime.yaml``,
    composed by the port (``experiment=ucfcrime``, FIT_VALUES and the paths) as
    the dict the port's module takes, on the feature set under ``frames_root``
    and ``annotations``, its run directory ``save_dir``
    (tests/test_torch_fit.py holds it to the JAX package's composition)."""
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    overrides = ["experiment=ucfcrime", *(f"{k}={v}" for k, v in FIT_VALUES.items()),
                 f"paths.root_dir={ROOT}", f"paths.output_dir={save_dir}", f"data.frames_root={frames_root}/",
                 f"data.annotations_root={annotations}/",
                 f"data.annotation_file_temporal_test={annotations / TEMPORAL_ANNOTATIONS}"]
    return to_dict(compose(default_config_dir(), "train", overrides))


class InstrumentedFit:
    """One ``AnomalyCLIPTrainModule`` built from ``cfg`` (or ``module``, built
    already), its readings taken on the host clock with the card synchronized:
    the metrics it logged by step, the seconds of each validation pass, test
    pass, checkpoint save and restore. ``after_step(n)`` runs after its n-th
    training step."""

    def __init__(self, cfg: dict, after_step=None, module=None):
        from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

        self.module = m = AnomalyCLIPTrainModule(cfg) if module is None else module
        self.logged, self.validate_s, self.save_s, self.restore_s = defaultdict(dict), [], [], []
        self.test_s = []
        log_metrics = m.loggers.log_metrics

        def logged(metrics, step):
            self.logged[step].update(metrics)
            log_metrics(metrics, step)

        m.loggers.log_metrics = logged
        m.validate = self.timed(m.validate, self.validate_s)
        m.test = self.timed(m.test, self.test_s)
        m.ckpt.save_epoch = self.timed(m.ckpt.save_epoch, self.save_s)
        m.ckpt.restore = self.timed(m.ckpt.restore, self.restore_s)
        if after_step is not None:
            build = m._build_train_step

            def build_hooked():
                step, taken = build(), [0]

                def hooked(*args):
                    out = step(*args)
                    taken[0] += 1
                    after_step(taken[0])
                    return out

                return hooked

            m._build_train_step = build_hooked

    @staticmethod
    def timed(fn, seconds: list):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            return out

        return call

    def losses(self, epoch: int) -> dict:
        from anomalyclip_tpu_torch.train.module import METRIC_NAMES

        return {k: self.logged[epoch][k] for k in METRIC_NAMES}

    def epoch_s(self) -> list:
        return [self.logged[e]["train/epoch_time_s"] for e in sorted(self.logged)
                if "train/epoch_time_s" in self.logged[e]]


def seeded_frames(size: int):
    """A test-mode frame source of seeded uint8 frames made in memory: the
    data layer's ``FrameSource`` with the JPEG decode replaced (the card's
    machine has neither cv2 nor PIL). Video ``Normal_<i>``'s frame ``f`` is
    drawn from (SEED, i, f)."""
    from anomalyclip_tpu_torch.data.sources import FrameSource

    class SeededFrames(FrameSource):
        def _load_one(self, record, file_idx: int) -> np.ndarray:
            rng = np.random.default_rng((SEED, int(record.rel_path.split("_")[-1]), file_idx))
            return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)

    return SeededFrames(input_size=size)


def frames_ncentroid_module(root: Path, counts: list):
    """The UCF-Crime module from frames (``load_from_features`` false, ViT-B/16
    at full width) whose normal training videos are ``counts`` frames long,
    read through ``seeded_frames``."""
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    annotations = root / "annotations"
    annotations.mkdir(parents=True)
    listing = annotations / "Anomaly_Train_Normal.txt"
    listing.write_text("".join(f"Normal_{i} 1 {n} {NORMAL_ID}\n" for i, n in enumerate(counts)))
    cfg = ucf_fit_config(root / "frames", annotations, root / "run")
    for key in ("annotation_file_anomaly", "annotation_file_normal", "annotation_file_test"):
        cfg["data"][key] = str(listing)
    cfg["data"]["load_from_features"] = cfg["model"]["net"]["load_from_features"] = False
    module = AnomalyCLIPTrainModule(cfg)
    module.datamodule._source = lambda: seeded_frames(module.model.clip_cfg.image_resolution)
    return module


@contextlib.contextmanager
def deterministic_mode():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` with
    CUBLAS_WORKSPACE_CONFIG=:4096:8, both restored after; yields the warnings
    caught meanwhile (an op without a deterministic form warns)."""
    import os
    import warnings

    from anomalyclip_tpu_torch.ops.attention import IMPL_ENV

    saved_env = {k: os.environ.get(k) for k in ("CUBLAS_WORKSPACE_CONFIG", IMPL_ENV)}
    saved_mode = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(saved_mode[0], warn_only=saved_mode[1])
        restore_env(saved_env)


def restore_env(saved: dict) -> None:
    import os

    for key, value in saved.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value


def phase_fit(smi: str, frames_root: Path, annotations: Path) -> dict:
    """The UCF-Crime training run through ``AnomalyCLIPTrainModule.fit`` on the
    feature set of phase 4f, under ``torch.use_deterministic_algorithms`` ->
    the kernel launch counts of its main path."""
    with tempfile.TemporaryDirectory(prefix="fit_runs_", dir=ROOT / "build") as tmp, deterministic_mode() as caught:
        return run_fits(smi, frames_root, annotations, Path(tmp), caught)


def run_fits(smi: str, frames_root: Path, annotations: Path, tmp: Path, caught: list) -> dict:
    """Phase 4g's fits A (uninterrupted), B (SIGTERM in epoch 1, then resumed
    from ``last`` by a fresh module) and C (A under the plain attention), the
    test passes and the from-frames ncentroid; see the module docstring."""
    import importlib.util
    import os
    import signal

    import anomalyclip_tpu_torch.train.module as train_module
    from anomalyclip_tpu_torch.convert import tree_leaves
    from anomalyclip_tpu_torch.ops.attention import IMPL_ENV, launch_counts, reset_launch_counts, route_counts
    from anomalyclip_tpu_torch.train.checkpoint import STATE_FILE
    from anomalyclip_tpu_torch.train.module import METRIC_NAMES, TrainingPreempted

    print(f"[fit] matplotlib {'present' if importlib.util.find_spec('matplotlib') else 'absent'} on this machine",
          flush=True)
    per_epoch = FEATURE_SET["num_abnormal"] // HALF_BATCH
    frame_counts = [int(n) for n in np.random.default_rng(SEED).integers(*FRAME_COUNTS, FRAME_VIDEOS,
                                                                          endpoint=True)]

    # the main path: counters from zero; A, B and its resume, the test passes,
    # the from-frames ncentroid
    reset_launch_counts()
    a = InstrumentedFit(ucf_fit_config(frames_root, annotations, tmp / "A"))
    a.module.fit()
    # the two test passes' outputs: test() returns only the metrics
    evaluate, test_outputs = train_module.evaluate_videos, []

    def recorded(*args, **kwargs):
        test_outputs.append(evaluate(*args, **kwargs))
        return test_outputs[-1]

    train_module.evaluate_videos = recorded
    try:
        a_test = a.module.test(state=a.module._final_state)
    finally:
        train_module.evaluate_videos = evaluate

    sigterm_before = signal.getsignal(signal.SIGTERM)
    b = InstrumentedFit(ucf_fit_config(frames_root, annotations, tmp / "B"),
                        after_step=lambda n: n == per_epoch + PREEMPT_AFTER_STEPS
                        and signal.raise_signal(signal.SIGTERM))
    try:
        b.module.fit()
        raise AssertionError("fit B ran to its end through a SIGTERM")
    except TrainingPreempted as exc:
        require("saved boundary: epoch 0" in str(exc), f"preempted with {exc}")
        print(f"[fit] B: {exc}", flush=True)
    require(signal.getsignal(signal.SIGTERM) is sigterm_before, "fit B left its SIGTERM handler installed")
    b_steps = per_epoch + PREEMPT_AFTER_STEPS
    resume_cfg = ucf_fit_config(frames_root, annotations, tmp / "B")
    resume_cfg["ckpt_path"] = str(tmp / "B" / "checkpoints" / "last")
    r = InstrumentedFit(resume_cfg)
    r.module.fit()

    fresh = InstrumentedFit(ucf_fit_config(frames_root, annotations, tmp / "A"))
    train_module.evaluate_videos = recorded
    try:
        fresh_test = fresh.module.test(ckpt_path=tmp / "A" / "checkpoints" / "last")
    finally:
        train_module.evaluate_videos = evaluate

    frames = frames_ncentroid_module(tmp / "frames", frame_counts)
    torch.cuda.synchronize()
    start = time.perf_counter()
    frames_nc = frames.compute_ncentroid()
    frames_s = time.perf_counter() - start
    torch.cuda.synchronize()
    launches, routes = dict(launch_counts), dict(route_counts)

    # exactly what the path ran: the text tower once a step and once a
    # validation or test pass (the scorer's constructor or update), its
    # backward once a step, the temporal model once a step and once a video
    # scored, its backward once a step; the image tower once an encode call
    steps = a.module._final_state.step + b_steps + (r.module._final_state.step - per_epoch)
    passes = len(a.validate_s) + len(b.validate_s) + len(r.validate_s) + 2
    videos = len(a.module.datamodule.test_dataloader())
    chunk = frames.model.ENCODE_CHUNK
    encode_calls = sum(-(-n // chunk) for n in frame_counts)
    text_layers, vision_layers = (frames.model.clip_cfg.transformer_layers, frames.model.clip_cfg.vision_layers)
    expected = dict.fromkeys(launch_counts, 0)
    expected.update({"fused_mha_qkv": text_layers * (steps + passes) + vision_layers * encode_calls,
                     "mha_qkv_bwd": text_layers * steps, "fused_mha_bld": 2 * (steps + videos * passes),
                     "mha_bld_bwd": 2 * steps})
    print(f"[fit] launches {launches}, expected {expected}", flush=True)
    require(launches == expected, f"launches {launches}, expected {expected}")
    launches.update(require_routes("fp32 fit", 0, 0, expected["fused_mha_qkv"], 0, expected["fused_mha_bld"],
                                   expected["mha_bld_bwd"], expected["mha_qkv_bwd"]))

    # C: A under the plain attention, and the from-frames pass again
    os.environ[IMPL_ENV] = "reference"
    reset_launch_counts()
    c = InstrumentedFit(ucf_fit_config(frames_root, annotations, tmp / "C"))
    c.module.fit()
    (frames.save_dir / "ncentroid.npy").unlink()
    frames_nc_plain = frames.compute_ncentroid()
    require(not any(launch_counts.values()) and not any(route_counts.values()),
            f"plain attention launched kernels: {launch_counts} {route_counts}")

    nondeterministic = sorted({str(w.message) for w in caught if "deterministic" in str(w.message)})
    for message in nondeterministic:
        print(f"[fit] not deterministic: {message}", flush=True)

    # the run directory of A
    run_a = tmp / "A"
    for name in ("checkpoints/epoch_000", "checkpoints/epoch_001", "checkpoints/epoch_002", "checkpoints/last",
                 "ncentroid.npy", "metrics_0.json", "metrics_1.json", "metrics_2.json", "metrics.json",
                 "csv/metrics.csv"):
        require((run_a / name).exists(), f"{name} missing from run A")
    ckpt = a.module.ckpt
    epoch0, epoch1 = (ckpt.restore(run_a / "checkpoints" / f"epoch_{e:03d}") for e in (0, 1))
    initial = a.module.init_state(per_epoch).trainable
    names = leaf_paths(initial)
    # epoch 0 of the warmup trains at lr 0: the weights stay, the moments fill
    for name, x, y in zip(names, tree_leaves(initial), tree_leaves(epoch0["trainable"]), strict=True):
        require(torch.equal(x.detach().cpu(), y), f"{name} moved in epoch 0 (lr 0)")
    moments = epoch0["optimizer"]["state"]
    require(len(moments) == len(names) and all(m["exp_avg"].abs().max() > 0 and m["exp_avg_sq"].max() > 0
                                               for m in moments.values()),
            "zero AdamW moments saved at the epoch-0 boundary")
    require(epoch0["count"] == per_epoch and epoch0["step"] == per_epoch, f"epoch 0 boundary {epoch0['step']}")
    for name, x, y in zip(names, tree_leaves(epoch0["trainable"]), tree_leaves(epoch1["trainable"]), strict=True):
        require(not torch.equal(x, y) and (x != y).any(), f"{name} did not move in epoch 1")

    def val_metrics(run: Path, epoch: int) -> np.ndarray:
        with open(run / f"metrics_{epoch}.json") as f:
            got = json.load(f)
        return np.array([got[k] for k in EVAL_METRICS])

    def losses(fit: InstrumentedFit, epoch: int) -> np.ndarray:
        return np.array([fit.losses(epoch)[k] for k in METRIC_NAMES])

    # B (epoch 0, then the resume through epochs 1-2) against A
    b_losses = {0: losses(b, 0), 1: losses(r, 1), 2: losses(r, 2)}
    final_a, final_b = a.module._final_state, r.module._final_state
    leaves_a = tree_leaves(final_a.trainable) + list(final_a.bn_state)
    leaves_b = tree_leaves(final_b.trainable) + list(final_b.bn_state)
    if not nondeterministic:
        for epoch in range(FIT_EPOCHS):
            np.testing.assert_array_equal(b_losses[epoch], losses(a, epoch), err_msg=f"epoch {epoch} losses, B vs A")
        for epoch in (1, 2):
            np.testing.assert_array_equal(val_metrics(tmp / "B", epoch), val_metrics(run_a, epoch),
                                          err_msg=f"epoch {epoch} metrics, B vs A")
        for name, x, y in zip(names + ["bn mean", "bn var"], leaves_a, leaves_b, strict=True):
            require(torch.equal(x, y), f"{name} after epoch 2, B vs A")
        b_vs_a = "to the bit"
    else:
        for epoch in range(FIT_EPOCHS):
            np.testing.assert_allclose(b_losses[epoch], losses(a, epoch), rtol=TRAIN_LOSS_RTOL, atol=0)
        for epoch in (1, 2):
            np.testing.assert_allclose(val_metrics(tmp / "B", epoch)[:4], val_metrics(run_a, epoch)[:4], rtol=0,
                                       atol=EVAL_METRIC_TOL)
        b_vs_a = "within the tolerances (not deterministic)"
    weight_gap = max((x - y).abs().max().item() for x, y in zip(leaves_a, leaves_b))

    # A against C, the plain attention
    loss_gap = metric_gap = 0.0
    for epoch in range(FIT_EPOCHS):
        np.testing.assert_allclose(losses(a, epoch), losses(c, epoch), rtol=TRAIN_LOSS_RTOL, atol=0,
                                   err_msg=f"epoch {epoch} losses, kernels vs plain")
        np.testing.assert_allclose(val_metrics(run_a, epoch)[:4], val_metrics(tmp / "C", epoch)[:4], rtol=0,
                                   atol=EVAL_METRIC_TOL, err_msg=f"epoch {epoch} metrics, kernels vs plain")
        loss_gap = max(loss_gap, float(np.max(np.abs(losses(a, epoch) / losses(c, epoch) - 1))))
        metric_gap = max(metric_gap, float(np.abs(val_metrics(run_a, epoch) - val_metrics(tmp / "C", epoch))[:4].max()))
    np.testing.assert_allclose(frames_nc, frames_nc_plain, rtol=0, atol=FP32_SLICE_TOL,
                               err_msg="from-frames ncentroid, kernels vs plain")
    require(np.isfinite(frames_nc).all() and frames_nc.shape == (FEATURE_DIM,), "from-frames ncentroid")

    # test(ckpt_path=last) in a fresh module against test(state=A's final):
    # the same tensors, scored at two points of the process, within RELOAD_TOL
    require(len(test_outputs) == 2, f"{len(test_outputs)} test passes recorded")
    np.testing.assert_array_equal(test_outputs[0]["labels"], test_outputs[1]["labels"])
    reload_gap = max(float(np.abs(test_outputs[0][k] - test_outputs[1][k]).max())
                     for k in ("abnormal_scores", "class_probs"))
    require(reload_gap <= RELOAD_TOL, f"test outputs, fresh module vs A: max|diff| {reload_gap:.3e}")
    require(a_test.keys() == fresh_test.keys(), "test metrics' keys")
    for key in a_test:
        np.testing.assert_allclose(fresh_test[key], a_test[key], rtol=0, atol=RELOAD_TOL,
                                   err_msg=f"test {key}: fresh module vs A")
    metrics_equal = all(np.array_equal(fresh_test[k], a_test[k]) for k in a_test)
    require(np.isfinite([a_test[k] for k in EVAL_METRICS]).all(), f"test metrics {a_test}")

    size = (run_a / "checkpoints" / "epoch_000" / STATE_FILE).stat().st_size
    epochs_a, epochs_r, epochs_c = a.epoch_s(), r.epoch_s(), c.epoch_s()
    print(f"[fit] A, {FIT_EPOCHS} epochs of {per_epoch} steps at batch {2 * HALF_BATCH}: seconds an epoch "
          f"{', '.join(f'{s:.3f}' for s in epochs_a)}; a validation pass over {videos} videos "
          f"{', '.join(f'{s:.4f}' for s in a.validate_s)} s; a checkpoint save "
          f"{', '.join(f'{s:.4f}' for s in a.save_s)} s, {size} bytes ({smi})")
    print(f"[fit] B resumed from epoch 0: restore {', '.join(f'{s:.4f}' for s in r.restore_s)} s, seconds an "
          f"epoch {', '.join(f'{s:.3f}' for s in epochs_r)} against A's {epochs_a[1]:.3f}, "
          f"{epochs_a[2]:.3f} (A's first {epochs_a[0]:.3f}); restore for test {fresh.restore_s[0]:.4f} s ({smi})")
    print(f"[fit] C, plain attention: seconds an epoch {', '.join(f'{s:.3f}' for s in epochs_c)}; validation "
          f"{', '.join(f'{s:.4f}' for s in c.validate_s)} s ({smi})")
    print(f"[fit] from-frames ncentroid over {FRAME_VIDEOS} videos of {frame_counts} frames, {encode_calls} "
          f"encode calls: {frames_s:.3f} s; kernels vs plain max|diff| "
          f"{np.abs(frames_nc - frames_nc_plain).max():.3e} (limit {FP32_SLICE_TOL:g}) ({smi})")
    print(f"[fit] B vs A {b_vs_a}: weights and BN max|diff| {weight_gap:.3e}; A vs C: losses max rel diff "
          f"{loss_gap:.3e} (limit {TRAIN_LOSS_RTOL:g}), AUC, AP, mAUC, mAP max|diff| {metric_gap:.3e} (limit "
          f"{EVAL_METRIC_TOL:g}); test AUC {a_test['auc_roc']:.6f} AP {a_test['auc_pr']:.6f} mAUC "
          f"{a_test['mean_mc_auroc']:.6f} mAP {a_test['mean_mc_aupr']:.6f}; the fresh module's test from `last`: "
          f"scores and class probs max|diff| {reload_gap:.3e} (limit {RELOAD_TOL:g}), metrics "
          f"{'equal to the bit' if metrics_equal else 'within the limit'}")
    torch.cuda.synchronize()
    return launches


def openai_clip_shapes(cfg) -> dict:
    """The keys and shapes of an OpenAI CLIP ViT state dict of ``cfg``: the
    ``state_dict()`` of the released ``ViT-B-16.pt`` for ``CLIPConfig.vit_b16()``
    (without the three integer entries OpenAI's ``build_model`` drops)."""
    w, tw, e, p = cfg.vision_width, cfg.transformer_width, cfg.embed_dim, cfg.vision_patch_size
    grid = cfg.image_resolution // p
    shapes = {
        "positional_embedding": (cfg.context_length, tw), "text_projection": (tw, e), "logit_scale": (),
        "visual.class_embedding": (w,), "visual.positional_embedding": (grid * grid + 1, w), "visual.proj": (w, e),
        "visual.conv1.weight": (w, 3, p, p), "visual.ln_pre.weight": (w,), "visual.ln_pre.bias": (w,),
        "visual.ln_post.weight": (w,), "visual.ln_post.bias": (w,),
        "token_embedding.weight": (cfg.vocab_size, tw), "ln_final.weight": (tw,), "ln_final.bias": (tw,),
    }
    for prefix, d, layers in (("visual.transformer", w, cfg.vision_layers), ("transformer", tw, cfg.transformer_layers)):
        for i in range(layers):
            b = f"{prefix}.resblocks.{i}"
            shapes.update({
                f"{b}.attn.in_proj_weight": (3 * d, d), f"{b}.attn.in_proj_bias": (3 * d,),
                f"{b}.attn.out_proj.weight": (d, d), f"{b}.attn.out_proj.bias": (d,),
                f"{b}.ln_1.weight": (d,), f"{b}.ln_1.bias": (d,), f"{b}.ln_2.weight": (d,), f"{b}.ln_2.bias": (d,),
                f"{b}.mlp.c_fc.weight": (4 * d, d), f"{b}.mlp.c_fc.bias": (4 * d,),
                f"{b}.mlp.c_proj.weight": (d, 4 * d), f"{b}.mlp.c_proj.bias": (d,),
            })
    return shapes


def seeded_clip_state_dict(cfg, seed: int) -> dict:
    """A state dict of ``openai_clip_shapes(cfg)`` in fp16, as OpenAI's files
    hold theirs, drawn from ``seed``: N(0, 0.02^2) everywhere, 1 added to the
    LayerNorm scales, the logit scale log(1/0.07)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in openai_clip_shapes(cfg).items():
        if key == "logit_scale":
            value = np.asarray(np.log(1 / 0.07), np.float32)
        else:
            value = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
            if key.endswith(".weight") and key.split(".")[-2].startswith("ln"):
                value += np.float32(1)
        sd[key] = torch.from_numpy(value).half()
    return sd


def entry_module_class(made: list):
    """``AnomalyCLIPTrainModule`` with every instance instrumented
    (``InstrumentedFit``, its build timed) and appended to ``made``."""
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    class Recorded(AnomalyCLIPTrainModule):
        def __init__(self, cfg, device=None):
            torch.cuda.synchronize()
            start = time.perf_counter()
            super().__init__(cfg, device)
            torch.cuda.synchronize()
            reading = InstrumentedFit(cfg, module=self)
            reading.build_s = time.perf_counter() - start
            made.append(reading)

    return Recorded


def ucf_data_root(tmp: Path, frames_root: Path, annotations: Path) -> Path:
    """The layout data/ucfcrime.yaml reads under UCFCRIME_ROOT, as links to the
    feature set, under ``tmp`` -> the root; sets UCFCRIME_ROOT to it and
    ANOMALYCLIP_NO_DOWNLOAD (the caller restores both)."""
    import os

    data_root = tmp / "UCFCrime"
    data_root.mkdir()
    (data_root / "Image-Features").symlink_to(frames_root.resolve(), target_is_directory=True)
    (data_root / "Annotations").symlink_to(annotations.resolve(), target_is_directory=True)
    (data_root / TEMPORAL_ANNOTATIONS).symlink_to((annotations / TEMPORAL_ANNOTATIONS).resolve())
    os.environ["UCFCRIME_ROOT"] = str(data_root)
    os.environ["ANOMALYCLIP_NO_DOWNLOAD"] = "1"
    return data_root


def phase_entry(smi: str, frames_root: Path, annotations: Path, keep: Path) -> dict:
    """The published UCF-Crime experiment through the port's command line on
    the feature set of phase 4f, under ``deterministic_mode`` -> the kernel
    launch counts of its main path. The entry run's directory and the CLIP
    file move to ``keep`` (``run``, ``ViT-B-16.pt``) for phase 4i."""
    import os

    saved = {k: os.environ.get(k) for k in ("UCFCRIME_ROOT", "ANOMALYCLIP_NO_DOWNLOAD")}
    try:
        with tempfile.TemporaryDirectory(prefix="entry_runs_", dir=ROOT / "build") as tmp, deterministic_mode() as caught:
            tmp = Path(tmp)
            ucf_data_root(tmp, frames_root, annotations)
            launches = run_entries(smi, tmp, caught)
            (tmp / "entry" / "train" / "runs" / "ucfcrime").rename(keep / "run")
            (tmp / "ViT-B-16.pt").rename(keep / "ViT-B-16.pt")
            return launches
    finally:
        restore_env(saved)


def run_entries(smi: str, tmp: Path, caught: list) -> dict:
    """Phase 4h's runs; see the module docstring."""
    import anomalyclip_tpu_torch.train.module as train_module
    from anomalyclip_tpu_torch import eval_entry, train_entry
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.convert import tree_leaves
    from anomalyclip_tpu_torch.models.clip.convert import load_torch_clip_checkpoint, state_dict_from_params
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
    from anomalyclip_tpu_torch.ops.attention import launch_counts, reset_launch_counts, route_counts
    from anomalyclip_tpu_torch.train.module import METRIC_NAMES

    phase_start = time.perf_counter()
    # the CLIP file: ViT-B/16 at its published width, fp16, OpenAI's key layout
    clip_path = tmp / "ViT-B-16.pt"
    clip_sd = seeded_clip_state_dict(CLIPConfig.vit_b16(), SEED)
    torch.save(clip_sd, clip_path)
    clip_bytes = clip_path.stat().st_size
    start = time.perf_counter()
    _, loaded_cfg = load_torch_clip_checkpoint(clip_path)
    load_s = time.perf_counter() - start
    require(loaded_cfg == CLIPConfig.vit_b16(), f"the CLIP file reads as {loaded_cfg}")

    args = ["experiment=ucfcrime", f"model.net.clip_ckpt_path={clip_path}", f"trainer.max_epochs={ENTRY_EPOCHS}",
            "model.net.select_idx_dropout_topk=0.0", "model.net.select_idx_dropout_bottomk=0.0", "logger=csv"]
    start = time.perf_counter()
    direct_cfg = to_dict(compose(default_config_dir(), "train", args + [f"paths.log_dir={tmp / 'direct'}"]))
    compose_s = time.perf_counter() - start
    require(direct_cfg["model"]["net"].get("clip_init", "pretrained") == "pretrained"
            and direct_cfg["trainer"]["accelerator"] == "tpu", "the published experiment's CLIP and trainer")

    # the main path: counters from zero; the train entry, the eval entry on its
    # run, a TPE search and a multirun, all through the entries
    made = []
    real_class = train_module.AnomalyCLIPTrainModule
    real_single_run = train_entry._single_run
    trial_s = []

    def timed_single_run(job):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        out = real_single_run(job)
        torch.cuda.synchronize()
        trial_s.append(time.perf_counter() - begin)
        return out

    reset_launch_counts()
    train_module.AnomalyCLIPTrainModule = entry_module_class(made)
    try:
        entry_test = train_entry.main(args + [f"paths.log_dir={tmp / 'entry'}"])
        entry = made[-1]
        run_dir = tmp / "entry" / "train" / "runs" / "ucfcrime"
        torch.cuda.synchronize()
        start = time.perf_counter()
        evaluated = eval_entry.main(["data=ucfcrime", "model=anomaly_clip_ucfcrime",
                                     f"model.net.clip_ckpt_path={clip_path}",
                                     f"ckpt_path={run_dir / 'checkpoints' / 'last'}",
                                     f"paths.log_dir={tmp / 'eval'}"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - start
        evaluator = made[-1]
        train_entry._single_run = timed_single_run
        search = train_entry.main(["experiment=ucfcrime", f"model.net.clip_ckpt_path={clip_path}",
                                   "hparams_search=ucfcrime_tpe", f"hparams_search.n_trials={SWEEP_TRIALS}",
                                   f"hparams_search.n_startup_trials={SWEEP_STARTUP}", "trainer.max_epochs=1",
                                   f"paths.log_dir={tmp / 'search'}"])
        search_s, trial_s = list(trial_s), []
        jobs = train_entry.main(["-m", "experiment=ucfcrime", f"model.net.clip_ckpt_path={clip_path}",
                                 "trainer.max_epochs=1", f"model.solver.lr={','.join(ENTRY_LRS)}",
                                 f"paths.log_dir={tmp / 'multirun'}"])
        multirun_s = list(trial_s)
    finally:
        train_module.AnomalyCLIPTrainModule = real_class
        train_entry._single_run = real_single_run
    torch.cuda.synchronize()
    launches, routes = dict(launch_counts), dict(route_counts)

    # exactly what the entries ran: the text tower once a step and once a
    # validation or test pass, its backward once a step, the temporal model
    # once a step and once a video scored, its backward once a step
    require(len(made) == 2 + SWEEP_TRIALS + len(ENTRY_LRS), f"{len(made)} modules built")
    steps = sum(m.module._final_state.step for m in made if hasattr(m.module, "_final_state"))
    passes = sum(len(m.validate_s) + len(m.test_s) for m in made)
    videos = len(entry.module.datamodule.test_dataloader())
    text_layers = entry.module.model.clip_cfg.transformer_layers
    expected = dict.fromkeys(launch_counts, 0)
    expected.update({"fused_mha_qkv": text_layers * (steps + passes), "mha_qkv_bwd": text_layers * steps,
                     "fused_mha_bld": 2 * (steps + videos * passes), "mha_bld_bwd": 2 * steps})
    print(f"[entry] launches {launches}, expected {expected}", flush=True)
    require(launches == expected, f"launches {launches}, expected {expected}")
    launches.update(require_routes("entry runs", 0, 0, expected["fused_mha_qkv"], 0, expected["fused_mha_bld"],
                                   expected["mha_bld_bwd"], expected["mha_qkv_bwd"]))

    # the CLIP on the card is the file's fp16 values upcast, to the bit
    clip_tree = entry.module.frozen["clip"]
    require(all(t.is_cuda for t in tree_leaves(clip_tree)), "the frozen CLIP tree is not on the card")
    on_card = state_dict_from_params(clip_tree)
    require(on_card.keys() == clip_sd.keys(), "the CLIP tree's keys")
    for key, value in clip_sd.items():
        require(torch.equal(on_card[key], value.float()), f"CLIP {key} on the card differs from the file")

    # the same run through the module directly, out of the main path's count
    direct = InstrumentedFit(direct_cfg)
    direct.module.fit()
    direct_test = direct.module.test(state=direct.module._final_state)
    nondeterministic = sorted({str(w.message) for w in caught if "deterministic" in str(w.message)})
    require(not nondeterministic, f"not deterministic: {nondeterministic}")
    for epoch in range(ENTRY_EPOCHS):
        got = [entry.logged[epoch][k] for k in METRIC_NAMES]
        want = [direct.logged[epoch][k] for k in METRIC_NAMES]
        require(got == want, f"epoch {epoch} losses, entry {got} vs module {want}")
        with open(run_dir / f"metrics_{epoch}.json") as f, \
                open(direct.module.save_dir / f"metrics_{epoch}.json") as g:
            require(json.load(f) == json.load(g), f"epoch {epoch} validation metrics, entry vs module")
    require(entry_test.keys() == direct_test.keys(), "test metrics' keys")
    for key in entry_test:
        np.testing.assert_array_equal(entry_test[key], direct_test[key], err_msg=f"test {key}, entry vs module")
    final_e, final_d = entry.module._final_state, direct.module._final_state
    for x, y in zip(tree_leaves(final_e.trainable) + list(final_e.bn_state),
                    tree_leaves(final_d.trainable) + list(final_d.bn_state), strict=True):
        require(torch.equal(x, y), "a final trainable leaf or the BN state, entry vs module")

    # the eval entry on the run's last checkpoint against the run's own test
    eval_gap = max(abs(evaluated[k] - entry_test[k]) for k in EVAL_METRICS[:4])
    require(eval_gap <= RELOAD_TOL, f"eval entry vs the run's test: max|diff| {eval_gap:.3e}")
    require(np.isfinite([entry_test[k] for k in EVAL_METRICS]).all(), f"test metrics {entry_test}")

    # the search: three trials, the last drawn by the Parzen model (its
    # startup trials both finite), a finite best; the multirun's two run dirs
    values = [t["value"] for t in search["trials"]]
    require(len(values) == SWEEP_TRIALS and all(v is not None and np.isfinite(v) for v in values),
            f"search trials {search['trials']}")
    require(search["best"] is not None and np.isfinite(search["best"]["value"]), f"search best {search['best']}")
    for i in range(SWEEP_TRIALS):
        require((tmp / "search" / "train" / "runs" / "ucfcrime" / f"trial_{i}" / "metrics.json").is_file(),
                f"trial {i} wrote no metrics.json")
    require(sorted(jobs) == list(range(len(ENTRY_LRS))) and not any("error" in r for r in jobs.values()),
            f"multirun {jobs}")
    for i in range(len(ENTRY_LRS)):
        require((tmp / "multirun" / "train" / "runs" / "ucfcrime" / str(i) / "checkpoints" / "last").is_dir(),
                f"multirun job {i} has no run dir")

    print(f"[entry] compose {compose_s:.4f} s; CLIP file {clip_bytes} bytes, load and convert {load_s:.3f} s; "
          f"module build (CLIP file included) {entry.build_s:.3f} s; epochs "
          f"{', '.join(f'{x:.3f}' for x in entry.epoch_s())} s; test pass {entry.test_s[0]:.4f} s; the whole "
          f"eval entry {eval_s:.3f} s (its test pass {evaluator.test_s[0]:.4f} s) ({smi})")
    print(f"[entry] TPE search of {SWEEP_TRIALS} trials, one epoch each: "
          f"{', '.join(f'{x:.3f}' for x in search_s)} s a trial; multirun of lr {', '.join(ENTRY_LRS)}: "
          f"{', '.join(f'{x:.3f}' for x in multirun_s)} s a job ({smi})")
    print(f"[entry] the entry run equals the module run to the bit (losses, validation and test metrics, trainable "
          f"leaves, BN state); eval vs the run's test max|diff| {eval_gap:.3e} (limit {RELOAD_TOL:g}); test AUC "
          f"{entry_test['auc_roc']:.6f} AP {entry_test['auc_pr']:.6f}; search values "
          f"{', '.join(f'{v:.6f}' for v in values)}, best trial {search['best']['trial']}; the CLIP on the card "
          f"equals the file's fp16 values upcast; the phase {time.perf_counter() - phase_start:.1f} s", flush=True)
    torch.cuda.synchronize()
    return launches


def counts_taken() -> dict:
    """The launch and route counts since they were last set to 0, which they
    are again."""
    from anomalyclip_tpu_torch.ops.attention import launch_counts, reset_launch_counts, route_counts

    counts = {**launch_counts, **route_counts}
    reset_launch_counts()
    return counts


def phase_serving(smi: str, frames_root: Path, annotations: Path, kept: Path) -> dict:
    """The serving surface on phase 4h's run, kept in ``kept``, and 4f's
    feature set -> the kernel launch and route counts of its main path."""
    import os

    saved = {k: os.environ.get(k) for k in ("UCFCRIME_ROOT", "ANOMALYCLIP_NO_DOWNLOAD")}
    try:
        with tempfile.TemporaryDirectory(prefix="serving_", dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            data_root = ucf_data_root(tmp, frames_root, annotations)
            return run_serving(smi, tmp, data_root, kept / "run", kept / "ViT-B-16.pt")
    finally:
        restore_env(saved)


# phase 4i's subprocess: predict.main on its arguments, timed, with its own
# launch and route counts and its resident memory (/proc/self/statm) after each
# stage (imports; the CUDA context; the module built; the input loaded; the
# input scored) and at its peak, sampled every 5 ms (the card's sandbox has no
# VmHWM; ru_maxrss would count the parent's peak, which it keeps across exec)
XD_CHILD = """
import json, os, sys, threading, time
import torch
from anomalyclip_tpu_torch import predict
from anomalyclip_tpu_torch.ops.attention import launch_counts, route_counts

PAGE = os.sysconf("SC_PAGE_SIZE")

def memory():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE

peak, done, stages = [memory()], threading.Event(), {}

def sample():
    while not done.wait(0.005):
        peak[0] = max(peak[0], memory())

def stage(name):
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    stages[name] = memory()

def then(name, fn):
    def staged(*args, **kwargs):
        out = fn(*args, **kwargs)
        stage(name)
        return out
    return staged

real_load = predict.load_module_and_state

def load(cfg, device):
    torch.zeros(1, device=device)
    stage("CUDA context")
    return real_load(cfg, device)

stage("imports")
predict.load_module_and_state = then("module built", load)
predict._load_input = then("input loaded", predict._load_input)
predict.score_input = then("input scored", predict.score_input)
sampler = threading.Thread(target=sample, daemon=True)
sampler.start()
start = time.perf_counter()
result = predict.main(sys.argv[1:])
torch.cuda.synchronize()
seconds = time.perf_counter() - start
done.set()
sampler.join()
print(json.dumps({"seconds": seconds, "peak": max(peak[0], memory(), *stages.values()), "stages": stages,
                  "num_frames": result["num_frames"],
                  "counts": {**launch_counts, **route_counts}}))
"""


def run_serving(smi: str, tmp: Path, data_root: Path, run: Path, clip_path: Path) -> dict:
    """Phase 4i's runs; see the module docstring."""
    import io
    import os
    import subprocess

    from anomalyclip_tpu_torch import eval_entry, export, extract_features, graft_entry, predict, serve
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.data.sampling import gather_frame_indices, test_start_indices
    from anomalyclip_tpu_torch.eval.evaluator import evaluate_videos
    from anomalyclip_tpu_torch.eval.grids import encode_frames_chunked, score_sampled_features
    from anomalyclip_tpu_torch.export import ServingArtifact
    from anomalyclip_tpu_torch.ops.attention import attention_impl

    phase_start = time.perf_counter()
    common = ["data=ucfcrime", "model=anomaly_clip_ucfcrime", f"model.net.clip_ckpt_path={clip_path}",
              f"ckpt_path={run / 'checkpoints' / 'last'}", "extras.print_config=False"]
    videos = [data_root / "Image-Features" / f"test_{i:03d}.npy" for i in range(SERVE_VIDEOS)]
    rng = np.random.default_rng(SEED + 5)
    frames_video = rng.integers(0, 256, (1, SERVE_FRAME_VIDEO, 224, 224, 3), dtype=np.uint8)
    counts = []  # the main path's counts, call by call

    def timed(fn):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - begin

    def exact(what: str, got: dict, k1: int, k2: int, k1_route: str = "mha_tf32") -> dict:
        """Exactly k1 K1 launches, all on k1_route, and k2 K2 launches, all on
        bld_tf32, and nothing else -> got."""
        return held(what, got, {"fused_mha_qkv": k1, k1_route: k1, "fused_mha_bld": k2, "bld_tf32": k2})

    def counted(what: str, fn, k1: int = 0, k2: int = 0, k1_route: str = "mha_tf32"):
        """A main-path call, the counts set to 0 just before it and read just
        after, held to ``exact`` -> (its output, its seconds). The references
        run outside these windows."""
        counts_taken()
        out, seconds = timed(fn)
        counts.append(exact(what, counts_taken(), k1, k2, k1_route))
        return out, seconds

    # the checkpoint-backed module, as the CLIs build it
    cfg = to_dict(compose(default_config_dir(), "eval", common + [f"paths.log_dir={tmp / 'module'}"]))
    (module, state), module_s = counted("load_module_and_state",
                                        lambda: predict.load_module_and_state(cfg, "cuda"))
    require(np.array_equal(module.ncentroid, np.load(run / "ncentroid.npy")), "the ncentroid beside the run")
    # K1 launches: the text tower once a scorer update (every score_input),
    # the image tower once an encode chunk; K2: the temporal model's two axial
    # attentions a layer, once a scoring call
    text_k1, image_layers = module.model.clip_cfg.transformer_layers, module.model.clip_cfg.vision_layers
    k2 = 2 * module.model.cfg.depth
    grid_frames = module.model.cfg.num_segments * module.model.cfg.seg_length
    frame_chunks = -(-(-(-SERVE_FRAME_VIDEO // grid_frames) * grid_frames) // module.model.ENCODE_CHUNK)

    # reference: the test pass's own scores of the first videos
    scorer = module._scorer(state)
    tested = []
    evaluate_videos(module.datamodule.test_dataloader(limit=SERVE_VIDEOS), scorer, module.model,
                    on_video=tested.append)
    require([Path(vs.path) for vs in tested] == videos, f"test videos {[vs.path for vs in tested]}")

    # predict CLI on each video; the scoring alone on the module
    cli_s, score_s, results, direct = [], [], {}, {}
    for path, vs in zip(videos, tested):
        out = tmp / "predict" / f"{path.stem}.json"
        result, seconds = counted(f"predict.main {path.stem}",
                                  lambda: predict.main(common + [f"input={path}", f"output={out}",
                                                                 f"paths.log_dir={tmp / 'cli'}"]),
                                  text_k1, k2)
        cli_s.append(seconds)
        require(json.loads(out.read_text()) == result, f"{out} is not the returned prediction")
        require(result["num_frames"] == len(vs.scores), f"{path.stem}: {result['num_frames']} frames")
        gap = max(float(np.abs(np.asarray(result["frame_scores"]) - vs.scores).max()),
                  float(np.abs(np.asarray(result["frame_top_class_prob"]) - vs.class_probs.max(axis=1)).max()))
        require(gap <= SERVE_TOL, f"{path.stem}: predict vs the test pass max|diff| {gap:.3e}")
        raw = predict._load_input(path, cfg["data"], 224)
        (direct[path], _), seconds = counted(f"score_input {path.stem}",
                                             lambda: predict.score_input(module, state, raw, str(path)),
                                             text_k1, k2)
        score_s.append(seconds)
        assert_videos_close(direct[path], vs, SERVE_TOL, f"{path.stem}: score_input vs the test pass")
        results[path] = result

    # score_input on frames against phase 4's entry on the same model
    (frames_vs, frames_result), frames_s = counted(
        "score_input on frames", lambda: predict.score_input(module, state, frames_video, "seeded_video"),
        text_k1 + image_layers * frame_chunks, k2)
    predictor = predict.Predictor(module.model, module.frozen, state.trainable, state.bn_state, module.ncentroid,
                                  sampling=module.datamodule.cfg, device="cuda")
    predictor_vs, _ = predictor.score_frames(frames_video, "seeded_video")
    frames_gap = assert_videos_close(frames_vs, predictor_vs, SERVE_TOL, "score_input vs Predictor, frames")
    check_video(frames_vs, frames_result, SERVE_FRAME_VIDEO, len(module.model.classnames) - 1)

    # serve, stdin and watch, one JSON per input, each the predict CLI's
    real_finish, finish_s = serve._finish, []

    def timed_finish(*args):
        finish_s.append(timed(lambda: real_finish(*args))[1])

    watch = tmp / "incoming"
    watch.mkdir()
    for path in videos:
        (watch / path.name).symlink_to(path.resolve())
    real_stdin = sys.stdin
    serve._finish = timed_finish
    try:
        sys.stdin = io.StringIO("".join(f"{path}\n" for path in videos))
        counted("serve (stdin)", lambda: serve.main(common + [f"output_dir={tmp / 'served_stdin'}",
                                                              f"paths.log_dir={tmp / 'serve'}"]),
                SERVE_VIDEOS * text_k1, SERVE_VIDEOS * k2)
        stdin_s = list(finish_s)
        counted("serve (watch)", lambda: serve.main(common + [f"watch={watch}", "poll_interval=0.25", "stop_after=1",
                                                              f"output_dir={tmp / 'served_watch'}",
                                                              f"paths.log_dir={tmp / 'serve'}"]),
                SERVE_VIDEOS * text_k1, SERVE_VIDEOS * k2)
    finally:
        sys.stdin, serve._finish = real_stdin, real_finish
    for mode in ("stdin", "watch"):
        for path in videos:
            out = tmp / f"served_{mode}" / f"{path.stem}.json"
            require(out.is_file(), f"serve ({mode}) wrote no {out.name}")
            got, want = json.loads(out.read_text()), dict(results[path])
            if mode == "watch":
                require(got.pop("input") == str(watch / path.name), f"watch input {out.name}")
                want.pop("input")
            require(got == want, f"serve ({mode}) {out.name} differs from the predict CLI's")

    # export (the text features once; the graphs are traced on fake tensors),
    # then the artifact on the card
    art_dir, export_s = counted("export", lambda: export.main(common + [f"out={tmp / 'artifact'}",
                                                                        f"paths.log_dir={tmp / 'x'}"]), text_k1)
    art_bytes = sum(f.stat().st_size for f in Path(art_dir).iterdir())
    art, load_s = counted("ServingArtifact.load", lambda: ServingArtifact.load(art_dir, device="cuda"))
    g_grids = {g: rng.standard_normal((g, 32, 16, FEATURE_DIM)).astype(np.float32) for g in (1, 2, 5)}
    g_want = {g: [t.cpu().numpy() for t in scorer._score(torch.from_numpy(x).cuda())] for g, x in g_grids.items()}
    raws = {path: predict._load_input(path, cfg["data"], 224) for path in videos}
    art_s, art_outputs = [], {}
    for path in videos:
        art_outputs[path], seconds = counted(f"the artifact on {path.stem}", lambda: art.score_video(raws[path]),
                                             0, k2)
        art_s.append(seconds)
    art_frames, art_frames_s = counted("the artifact on frames", lambda: art.score_video(frames_video),
                                       image_layers * frame_chunks, k2)
    g_got = {g: counted(f"the score graph at g = {g}", lambda: art.score(x), 0, k2)[0] for g, x in g_grids.items()}
    artifact_counts = {k: sum(c[k] for c in counts[-len(videos) - 1 - len(g_grids):]) for k in counts[0]}
    gaps = []
    for path in videos:
        want = direct[path]
        for got, name in zip(art_outputs[path], ("similarity", "scores", "class_probs")):
            gaps.append(float(np.abs(got - getattr(want, name)).max()))
    require(max(gaps) <= SERVE_TOL, f"artifact vs checkpoint on features max|diff| {max(gaps):.3e}")
    frames_art_gap = max(float(np.abs(got - getattr(frames_vs, name)).max())
                         for got, name in zip(art_frames, ("similarity", "scores", "class_probs")))
    require(frames_art_gap <= ARTIFACT_FRAMES_TOL, f"artifact vs checkpoint from frames {frames_art_gap:.3e}")
    g_gap = max(float(np.abs(a - b).max()) for g in g_grids for a, b in zip(g_got[g], g_want[g]))
    require(g_gap <= SERVE_TOL, f"score graph at g = 1, 2, 5 vs the scorer max|diff| {g_gap:.3e}")

    # the eval entry on the artifact against the checkpoint's eval
    test_videos = len(module.datamodule.test_dataloader())
    ckpt_eval, ckpt_eval_s = timed(lambda: eval_entry.main(common + [f"paths.log_dir={tmp / 'eval_ckpt'}"]))
    art_eval, art_eval_s = counted("eval_entry artifact=", lambda: eval_entry.main(
        [f"artifact={art_dir}", "data=ucfcrime", "extras.print_config=False",
         f"paths.output_dir={tmp / 'eval_art'}"]), 0, k2 * test_videos)
    eval_gap = max(abs(art_eval[k] - ckpt_eval[k]) for k in EVAL_METRICS[:4])
    require(eval_gap <= SERVE_TOL, f"artifact eval vs checkpoint eval max|diff| {eval_gap:.3e}")

    # extraction: encode and write seeded uint8 videos, no decoder
    writer, _ = counted("FeatureWriter", lambda: extract_features.FeatureWriter(
        module.frozen["clip"], module.model.clip_cfg, torch.float32, "cuda"))
    extract_s, extract_gap = 0.0, 0.0
    for n in EXTRACT_FRAMES:
        video = rng.integers(0, 256, (1, n, 224, 224, 3), dtype=np.uint8)
        out = tmp / "extract" / f"video_{n}.npy"
        feats, seconds = counted(f"extraction of {n} frames", lambda: writer.write(
            out, [writer.encode(video[:, lo:lo + writer.batch]) for lo in range(0, n, writer.batch)]),
            image_layers * -(-n // writer.batch))
        extract_s += seconds
        want = encode_frames_chunked(lambda part: module.model.encode_frames(module.frozen, part), video[0], "cuda")
        require(np.array_equal(np.load(out), feats) and feats.shape == want.shape, f"{out.name}")
        extract_gap = max(extract_gap, float(np.abs(feats - want).max()))
    require(extract_gap <= SERVE_TOL, f"extracted features vs encode_frames max|diff| {extract_gap:.3e}")

    # the graft entry: bf16, K1 on the tensor-core kernel, K2 on bld_tf32
    cfg16, clip16 = graft_entry.flagship_config()
    graft_k1 = clip16.transformer_layers + clip16.vision_layers * (cfg16.num_segments * cfg16.seg_length // 256)
    (fn, args), _ = counted("graft_entry.entry", graft_entry.entry)
    (sim16, scores16), graft_s = counted("the graft entry's function", lambda: fn(*args), graft_k1,
                                         2 * cfg16.depth, "mha_tc")
    graft_counts = counts[-1]
    with attention_impl("reference"):
        ref_sim, ref_scores = fn(*args)
    graft_gap = max(float((sim16.float() - ref_sim.float()).abs().max()),
                    float((scores16.float() - ref_scores.float()).abs().max()))
    require(torch.isfinite(sim16).all() and torch.isfinite(scores16).all() and graft_gap <= BF16_SLICE_TOL,
            f"graft entry kernels vs plain max|diff| {graft_gap:.3e}")
    del fn, args
    torch.cuda.empty_cache()

    # XD-Violence scale: one long feature file through predict in a subprocess,
    # which counts its own launches
    xd = tmp / "xd_video.npy"
    np.save(xd, np.float32(0.1) * rng.standard_normal((XD_FRAMES, FEATURE_DIM), dtype=np.float32))
    xd_out = tmp / "xd_video.json"
    proc = subprocess.run([sys.executable, "-c", XD_CHILD, *common, f"input={xd}", f"output={xd_out}",
                           f"paths.log_dir={tmp / 'xd'}"], cwd=ROOT, env=dict(os.environ),
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"XD child failed: {proc.stderr[-2000:]}")
    xd_run = json.loads(proc.stdout.strip().splitlines()[-1])
    counts.append(exact("the XD child", xd_run["counts"], text_k1, k2))
    mib = {name: round(x / 2**20, 1) for name, x in {**xd_run["stages"], "peak": xd_run["peak"]}.items()}
    growth = mib["peak"] - mib["CUDA context"]
    print(f"[serve] XD child resident MiB after each stage and at its peak {mib} ({smi})", flush=True)
    require(growth <= XD_GROWTH_MIB, f"XD child: peak resident {growth:.1f} MiB above the CUDA context's "
                                     f"(limit {XD_GROWTH_MIB})")
    xd_scores = np.asarray(json.loads(xd_out.read_text())["frame_scores"])
    raw = predict._load_input(xd, cfg["data"], 224)
    starts, segment_size = test_start_indices(XD_FRAMES, 32, 16, 1)
    sampled = raw[:, gather_frame_indices(starts, 16, 1, XD_FRAMES)]

    def chunked(grids):
        parts = [scorer.score_grids(grids[i:i + XD_CHUNK_GRIDS]) for i in range(0, len(grids), XD_CHUNK_GRIDS)]
        return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])

    _, xd_chunked, _ = score_sampled_features(sampled, segment_size, 32, 16, 1, XD_FRAMES, chunked)
    xd_gap = float(np.abs(xd_scores - xd_chunked).max())
    require(xd_run["num_frames"] == XD_FRAMES == len(xd_scores) and xd_gap <= XD_CHUNK_TOL,
            f"XD: {xd_run['num_frames']} frames, chunk-aligned max|diff| {xd_gap:.3e}")
    torch.cuda.synchronize()

    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    print(f"[serve] launches, {len(counts)} main-path calls each held exactly {launches}; the artifact's calls "
          f"{artifact_counts}; the graft entry's {graft_counts}", flush=True)
    print(f"[serve] module from the run {module_s:.3f} s; predict CLI a video "
          f"{', '.join(f'{x:.3f}' for x in cli_s)} s, its scoring alone {', '.join(f'{x:.4f}' for x in score_s)} s; "
          f"from {SERVE_FRAME_VIDEO} uint8 frames {frames_s:.3f} s (vs Predictor max|diff| {frames_gap:.3e}) ({smi})")
    print(f"[serve] serve an input (stdin) {', '.join(f'{x:.4f}' for x in stdin_s)} s, (watch) "
          f"{', '.join(f'{x:.4f}' for x in finish_s[len(stdin_s):])} s; export {export_s:.3f} s, "
          f"{art_bytes} B; load {load_s:.3f} s ({smi})")
    print(f"[serve] artifact a video {', '.join(f'{x:.4f}' for x in art_s)} s vs checkpoint "
          f"{', '.join(f'{x:.4f}' for x in score_s)} s; from frames {art_frames_s:.3f} s vs {frames_s:.3f} s; "
          f"max|diff| features {max(gaps):.3e} (limit {SERVE_TOL:g}), frames {frames_art_gap:.3e} (limit "
          f"{ARTIFACT_FRAMES_TOL:g}), g = 1, 2, 5 {g_gap:.3e}; eval artifact {art_eval_s:.3f} s vs checkpoint "
          f"{ckpt_eval_s:.3f} s, metrics max|diff| {eval_gap:.3e} ({smi})")
    print(f"[serve] extraction {sum(EXTRACT_FRAMES) / extract_s:.1f} frames/s, vs encode_frames max|diff| "
          f"{extract_gap:.3e}; graft entry {graft_s:.3f} s, kernels vs plain max|diff| {graft_gap:.3e} (limit "
          f"{BF16_SLICE_TOL:g}); XD {XD_FRAMES} frames through predict in a subprocess {xd_run['seconds']:.3f} s, "
          f"peak resident {mib['peak']:.1f} MiB, {growth:.1f} MiB above the CUDA context's (limit {XD_GROWTH_MIB}; "
          f"statm sampled every 5 ms), vs chunk-aligned max|diff| {xd_gap:.3e} (limit {XD_CHUNK_TOL:g}); the "
          f"phase {time.perf_counter() - phase_start:.1f} s ({smi})", flush=True)
    return launches


@contextlib.contextmanager
def seeded_decode(frames: np.ndarray):
    """The input loader of predict and serve with the decode of any video file
    named ``seeded_*.mp4`` replaced by ``frames`` (ncrops, T, H, W, 3) uint8, as
    4g replaces the JPEG decode: the card's machine has no video decoder."""
    from anomalyclip_tpu_torch import predict, serve

    real = predict._load_input

    def load(path, data_cfg, input_size):
        path = Path(path)
        if path.name.startswith("seeded_") and path.suffix == ".mp4":
            require(input_size == frames.shape[-2], f"{path.name}: the model reads {input_size} px frames")
            return frames
        return real(path, data_cfg, input_size)

    predict._load_input = serve._load_input = load
    try:
        yield
    finally:
        predict._load_input = serve._load_input = real


def held(what: str, got: dict, want: dict) -> dict:
    """Exactly the launch and route counts ``want`` (a name it lacks: 0) -> got."""
    full = dict.fromkeys(got, 0)
    full.update(want)
    require(got == full, f"{what}: launches {({k: v for k, v in got.items() if v})}, expected "
                         f"{({k: v for k, v in full.items() if v})}")
    return got


def int8_local_gaps(qvisual, cfg, frames: torch.Tensor, dtype: torch.dtype) -> float:
    """Every layer's attention in the int8 tower on uint8 ``frames``, the
    kernel against the plain version on that layer's own qkv
    (``scripts.probe_int8_drift``), held at the kernels' limit -> the largest
    gap. Outside any counted window."""
    from anomalyclip_tpu_torch.models.clip.model import normalize_frames_on_device
    from anomalyclip_tpu_torch.scripts import probe_int8_drift as drift

    _, layers = drift.run_int8(qvisual, cfg, normalize_frames_on_device(frames), dtype, "kernel")
    gaps = drift.local_gaps(layers, cfg.vision_heads)
    del layers
    limit = TOLERANCE[torch.float32] if dtype == torch.float32 else TC_TOLERANCE
    require(len(gaps) == cfg.vision_layers and max(gaps) <= limit,
            f"int8 {cfg.vision_width}-wide {dtype}: {len(gaps)} layers, attention kernel vs plain on the "
            f"layer's own qkv max|diff| {max(gaps):.3e} (limit {limit:g})")
    return max(gaps)


def cosines(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    a, b = a.double(), b.double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).cpu().numpy()


def int8_gemm_shapes() -> dict:
    """Every int8 GEMM of the int8 ViT-B/16 tower at one 256-frame encode chunk
    (and its final projection at 8 frames, M <= 16) and of the ViT-L/14@336px
    tower at TOWER_FRAMES frames (its patch embed's K = 588) -> name: (M, K, N)."""
    shapes = {}
    for arch, width, patches, embed, frames in (("ViT-B/16", 768, 196, 512, 256),
                                                ("ViT-L/14@336px", 1024, 576, 768, TOWER_FRAMES)):
        k_patch = 3 * (16 if arch == "ViT-B/16" else 14) ** 2
        rows = frames * (patches + 1)
        shapes.update({
            f"{arch} patch embed": (frames * patches, k_patch, width), f"{arch} qkv": (rows, width, 3 * width),
            f"{arch} out": (rows, width, width), f"{arch} fc": (rows, width, 4 * width),
            f"{arch} proj": (rows, 4 * width, width), f"{arch} final proj": (frames, width, embed),
        })
    shapes["ViT-B/16 final proj at 8 frames"] = (8, 768, 512)
    return shapes


def phase_towers(smi: str, frames_root: Path, annotations: Path, kept: Path) -> dict:
    """The RN50 tower and the int8 tower on the serving path, on phase 4h's run,
    kept in ``kept``, and 4f's feature set -> the kernel launch and route counts
    of its main path."""
    import os

    saved = {k: os.environ.get(k) for k in ("UCFCRIME_ROOT", "ANOMALYCLIP_NO_DOWNLOAD")}
    try:
        with tempfile.TemporaryDirectory(prefix="towers_", dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            ucf_data_root(tmp, frames_root, annotations)
            return run_towers(smi, tmp, kept / "run", kept / "ViT-B-16.pt")
    finally:
        restore_env(saved)


def run_towers(smi: str, tmp: Path, run: Path, clip_path: Path) -> dict:
    """Phase 4j's runs; see the module docstring."""
    import io

    from anomalyclip_tpu_torch import predict, serve
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.convert import tree_leaves, tree_map, tree_to
    from anomalyclip_tpu_torch.models.clip import quant
    from anomalyclip_tpu_torch.models.clip.convert import state_dict_from_params
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, encode_image, init_clip_params
    from anomalyclip_tpu_torch.ops.attention import attention_impl
    from anomalyclip_tpu_torch.train.checkpoint import save_ncentroid
    from anomalyclip_tpu_torch.train.module import AnomalyCLIPTrainModule

    phase_start = time.perf_counter()
    # phase 4i's seeded video (the same seed, the same first draw)
    frames_video = np.random.default_rng(SEED + 5).integers(0, 256, (1, SERVE_FRAME_VIDEO, 224, 224, 3),
                                                            dtype=np.uint8)
    video = tmp / SEEDED_VIDEO
    video.touch()
    counts, readings = [], defaultdict(dict)

    def timed(fn):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - begin

    def counted(what: str, fn, want: dict):
        """A main-path call in a window of its own, held to ``want`` ->
        (its output, its seconds). The references run outside these windows."""
        counts_taken()
        out, seconds = timed(fn)
        counts.append(held(what, counts_taken(), want))
        return out, seconds

    def scoring(k1: int, dtype: str, k2: int = 2, key: str = "fused_mha_qkv") -> dict:
        route = "mha_tf32" if dtype == "float32" else "mha_tc"
        return {key: k1, route: k1, "fused_mha_bld": k2, "bld_tf32": k2}

    # ---- the int8 GEMMs, exact against an fp64 product of the same operands
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gemm_s = {}
    for name, (m, k, n) in int8_gemm_shapes().items():
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda", generator=gen)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda", generator=gen)
        got, gemm_s[name] = timed(lambda: quant.int8_matmul(a, w))
        require(got.dtype == torch.int32 and got.shape == (m, n), f"int8 GEMM {name}: {got.dtype} {tuple(got.shape)}")
        require(torch.equal(got.double(), a.double() @ w.double().T), f"int8 GEMM {name} (M, K, N) = {(m, k, n)} "
                                                                      "differs from the fp64 product")
    del a, w, got
    print(f"[towers] every int8 GEMM equals the fp64 product of its int8 operands: "
          + "; ".join(f"{name} {int8_gemm_shapes()[name]} {s * 1e3:.3f} ms" for name, s in gemm_s.items())
          + f" (one call each, cold; {smi})", flush=True)

    # ---- RN50: a seeded fp16 file at the full shapes, its own run directory
    rn_start = time.perf_counter()
    rn_params = init_clip_params(torch.Generator().manual_seed(SEED + 7), CLIPConfig.rn50())
    bn_gen = torch.Generator().manual_seed(SEED + 8)
    for layer in [rn_params["visual"]["stem"], *(b for li in range(1, 5) for b in rn_params["visual"][f"layer{li}"])]:
        for bn in (v for v in layer.values() if isinstance(v, dict)):  # eval-mode BN with real statistics
            bn["mean"] = 0.1 * torch.randn(bn["mean"].shape, generator=bn_gen)
            bn["var"] = 0.5 + torch.rand(bn["var"].shape, generator=bn_gen)
    rn_file = tmp / "RN50.pt"
    torch.save({k: v.half() for k, v in state_dict_from_params(rn_params).items()}, rn_file)
    rn_bytes = rn_file.stat().st_size
    rn_args = ["data=ucfcrime", "model=anomaly_clip_ucfcrime", "model.net.arch=RN50",
               f"model.net.clip_ckpt_path={rn_file}"]
    init_module = AnomalyCLIPTrainModule(
        to_dict(compose(default_config_dir(), "train", ["experiment=ucfcrime", *rn_args[2:],
                                                         f"paths.log_dir={tmp / 'rn50_init'}"])), device="cuda")
    rn_dim = CLIPConfig.rn50().embed_dim
    require(init_module.model.clip_cfg == CLIPConfig.rn50() and init_module.model.temporal_cfg.input_size == rn_dim,
            f"the RN50 file builds {init_module.model.clip_cfg}")
    # the CLIP on the card is the file's fp16 values upcast
    for got, want in zip(tree_leaves(init_module.frozen["clip"]),
                         tree_leaves(tree_map(lambda t: t.half().float(), rn_params)), strict=True):
        require(got.device.type == "cuda" and torch.equal(got.cpu(), want),
                "the RN50 tree on the card differs from the file")
    init_state = init_module.init_state(1)
    rn_run = init_module.save_dir
    init_module.ckpt.save_epoch(0, {**init_module._boundary(init_state), "epoch": 0})
    save_ncentroid(rn_run, (0.1 * np.random.default_rng(SEED + 6).standard_normal(rn_dim)).astype(np.float32))
    del init_module, init_state
    rn_setup_s = time.perf_counter() - rn_start

    def score_paths(tag: str, args: list, dtype: str, image_k1: int) -> dict:
        """The predict CLI, then a module built as the CLIs build it scoring the
        video twice (cold, warm), then the same under the plain attention ->
        the module, state, the warm scores and the seconds."""
        args = args + [f"model.net.compute_dtype={dtype}", "extras.print_config=False"]
        out = tmp / f"{tag}_{dtype}.json"
        with seeded_decode(frames_video):
            result, cli_s = counted(f"{tag} {dtype} predict.main", lambda: predict.main(
                args + [f"input={video}", f"output={out}", f"paths.log_dir={tmp / 'cli'}"]),
                scoring(text_k1 + image_k1, dtype))
        require(json.loads(out.read_text()) == result, f"{out.name} is not the returned prediction")
        cfg = to_dict(compose(default_config_dir(), "eval", args + [f"paths.log_dir={tmp / 'module'}"]))
        (module, state), _ = counted(f"{tag} {dtype} load_module_and_state",
                                     lambda: predict.load_module_and_state(cfg, "cuda"), {})
        calls = []
        for _ in range(2):  # cold: the scorer built (int8: the tower quantized), then warm
            calls.append(counted(f"{tag} {dtype} score_input", lambda: predict.score_input(
                module, state, frames_video, str(video)), scoring(text_k1 + image_k1, dtype)))
        (vs, warm_result), warm_s = calls[-1]
        check_video(vs, warm_result, SERVE_FRAME_VIDEO, len(module.model.classnames) - 1)
        cli_gap = float(np.abs(np.asarray(result["frame_scores"]) - vs.scores).max())
        require(cli_gap <= SERVE_TOL, f"{tag} {dtype}: predict CLI vs score_input max|diff| {cli_gap:.3e}")
        with attention_impl("reference"):
            ref_vs, _ = predict.score_input(module, state, frames_video, str(video))
        readings[tag][dtype] = dict(cli_s=cli_s, cold_s=calls[0][1], warm_s=warm_s)
        return SimpleNamespace(module=module, state=state, vs=vs, ref_vs=ref_vs)

    text_k1 = CLIPConfig.vit_b16().transformer_layers
    grid_frames = 32 * 16
    chunks = -(-(-(-SERVE_FRAME_VIDEO // grid_frames) * grid_frames) // 256)
    for dtype in ("float32", "bfloat16"):
        # RN50: the image tower is convs and an einsum pool (no kernel); K1 is
        # the text tower's, K2 the temporal model's
        scored = score_paths("RN50", rn_args + [f"ckpt_path={rn_run / 'checkpoints' / 'last'}"], dtype, 0)
        limit = FP32_SLICE_TOL if dtype == "float32" else BF16_SLICE_TOL
        gap = assert_videos_close(scored.vs, scored.ref_vs, limit, f"RN50 {dtype} kernels vs plain")
        readings["RN50"][dtype].update(gap=gap, limit=limit)
        del scored

    # ---- int8 ViT-B/16 on 4h's run: predict, the fp tower beside it, serve
    int8_args = ["data=ucfcrime", "model=anomaly_clip_ucfcrime", f"model.net.clip_ckpt_path={clip_path}",
                 f"ckpt_path={run / 'checkpoints' / 'last'}", "model.net.quantize=int8"]
    image_k1 = CLIPConfig.vit_b16().vision_layers * chunks
    serve_inputs = [tmp / "seeded_a.mp4", tmp / "seeded_b.mp4"]
    for path in serve_inputs:
        path.touch()
    for dtype in ("float32", "bfloat16"):
        scored = score_paths("int8", int8_args, dtype, image_k1)
        module, state = scored.module, scored.state
        encode = module._encode_fn()
        require(getattr(encode, "int8", False), f"int8 {dtype}: the module serves the fp tower")
        qvisual, quantize_s = counted(f"int8 {dtype} quantize_clip_visual",
                                      lambda: quant.quantize_clip_visual(module.frozen["clip"]), {})
        # phase 4's entry, the fp tower, on the same frames and module
        predictor = predict.Predictor(module.model, module.frozen, state.trainable, state.bn_state,
                                      module.ncentroid, sampling=module.datamodule.cfg, device="cuda")
        fp_runs = [counted(f"fp {dtype} Predictor.score_frames", lambda: predictor.score_frames(frames_video),
                           scoring(image_k1, dtype)) for _ in range(2)]
        fp_vs, fp_s = fp_runs[-1][0][0], [run[1] for run in fp_runs]
        # the checks, outside the windows: each layer's attention on 256 of
        # the frames; end to end within the int8 tower's own rounding noise
        part = torch.from_numpy(frames_video[0, :256]).cuda()
        local = int8_local_gaps(qvisual, module.model.clip_cfg, part, module.model.cfg.dtype)
        noise = max(float(np.abs(getattr(scored.vs, n) - getattr(fp_vs, n)).max())
                    for n in ("scores", "similarity", "class_probs"))
        gap = assert_videos_close(scored.vs, scored.ref_vs, INT8_NOISE_RATIO * noise,
                                  f"int8 {dtype} kernels vs plain (int8 vs fp {noise:.3e})")
        cos = cosines(encode(module.frozen, part), module.model.encode_frames(module.frozen, part))
        require(bool((cos > INT8_COSINE).all()), f"int8 {dtype}: cosine to the fp tower {cos.min():.6f}")
        # serve: two inputs through one warm service; the second is warm
        real_finish, finish_s = serve._finish, []

        def timed_finish(*args):
            finish_s.append(timed(lambda: real_finish(*args))[1])

        served = tmp / f"served_{dtype}"
        real_stdin, serve._finish = sys.stdin, timed_finish
        try:
            sys.stdin = io.StringIO("".join(f"{path}\n" for path in serve_inputs))
            with seeded_decode(frames_video):
                counted(f"int8 {dtype} serve", lambda: serve.main(
                    int8_args + [f"model.net.compute_dtype={dtype}", "extras.print_config=False",
                                 f"output_dir={served}", f"paths.log_dir={tmp / 'serve'}"]),
                        {k: 2 * v for k, v in scoring(text_k1 + image_k1, dtype).items()})
        finally:
            sys.stdin, serve._finish = real_stdin, real_finish
        for path in serve_inputs:
            out = served / f"{path.stem}.json"
            require(out.is_file(), f"serve int8 {dtype} wrote no {out.name}")
            got = json.loads(out.read_text())
            served_gap = float(np.abs(np.asarray(got["frame_scores"]) - scored.vs.scores).max())
            require(served_gap <= SERVE_TOL, f"serve int8 {dtype} {out.name} vs score_input max|diff| {served_gap:.3e}")
        readings["int8"][dtype].update(quantize_s=quantize_s, fp_cold_s=fp_s[0], fp_warm_s=fp_s[1],
                                       serve_s=finish_s, cosine=float(cos.min()), local=local, gap=gap,
                                       noise=noise)
        del scored, module, state, predictor, encode, part, qvisual, fp_runs, fp_vs
        torch.cuda.empty_cache()

    # ---- int8 ViT-L/14@336px: the core rung into K8 in fp32, the qtile rung
    # into K6 (strided views of the packed qkv) in bf16
    l14_cfg = CLIPConfig.vit_l14_336()
    l14 = tree_to({"visual": init_clip_params(torch.Generator().manual_seed(SEED + 9), l14_cfg)["visual"]}, "cuda")
    q14, q14_s = counted("ViT-L/14@336px quantize_clip_visual", lambda: quant.quantize_clip_visual(l14), {})
    tower_frames = torch.from_numpy(np.random.default_rng(SEED + 10).integers(
        0, 256, (TOWER_FRAMES, 336, 336, 3), dtype=np.uint8)).cuda()
    layers = l14_cfg.vision_layers
    want14 = {"float32": {"flash_attention_heads": layers, "mha_tf32": layers},
              "bfloat16": {"fused_mha_qtile": layers, "mha_tc": layers}}
    for dtype in ("float32", "bfloat16"):
        torch_dtype = getattr(torch, dtype)
        runs = [counted(f"ViT-L/14@336px int8 {dtype}", lambda: quant.encode_image_int8(
            q14, l14_cfg, tower_frames, torch_dtype), want14[dtype]) for _ in range(2)]
        feats = runs[-1][0]
        require(torch.equal(feats, runs[0][0]), f"ViT-L/14@336px int8 {dtype}: two calls differ")
        local = int8_local_gaps(q14, l14_cfg, tower_frames, torch_dtype)
        with attention_impl("reference"):
            ref = quant.encode_image_int8(q14, l14_cfg, tower_frames, torch_dtype)
        fp = encode_image(l14, l14_cfg, tower_frames, torch_dtype)
        noise = float((feats.float() - fp.float()).abs().max())
        gap = float((feats.float() - ref.float()).abs().max())
        require(torch.isfinite(feats).all() and gap <= INT8_NOISE_RATIO * noise,
                f"ViT-L/14@336px int8 {dtype} kernels vs plain max|diff| {gap:.3e} (int8 vs fp {noise:.3e})")
        cos = np.minimum(cosines(feats, fp), cosines(ref, fp))
        require(bool((cos > INT8_COSINE).all()), f"ViT-L/14@336px int8 {dtype}: cosine {cos.min():.6f}")
        readings["L14 int8"][dtype] = dict(cold_s=runs[0][1], warm_s=runs[1][1], gap=gap, noise=noise,
                                           local=local, cosine=float(cos.min()))
    del l14, q14, tower_frames
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    print(f"[towers] launches, {len(counts)} main-path calls each held exactly {launches}", flush=True)
    print(f"[towers] RN50: a seeded fp16 file of {rn_bytes} B at the full shapes and its run directory "
          f"{rn_setup_s:.3f} s; from {SERVE_FRAME_VIDEO} uint8 frames: "
          + "; ".join(f"{d} predict CLI {r['cli_s']:.3f} s, score_input cold {r['cold_s']:.4f} s, warm "
                      f"{r['warm_s']:.4f} s, kernels vs plain max|diff| {r['gap']:.3e} (limit {r['limit']:g})"
                      for d, r in readings["RN50"].items()) + f" ({smi})", flush=True)
    print(f"[towers] int8 ViT-B/16 on 4h's run, from {SERVE_FRAME_VIDEO} uint8 frames: "
          + "; ".join(f"{d} quantization {r['quantize_s']:.4f} s, predict CLI {r['cli_s']:.3f} s, score_input "
                      f"cold {r['cold_s']:.4f} s, warm {r['warm_s']:.4f} s beside the fp tower's "
                      f"(Predictor.score_frames) {r['fp_warm_s']:.4f} s (cold {r['fp_cold_s']:.4f} s), serve an "
                      f"input {', '.join(f'{x:.4f}' for x in r['serve_s'])} s; each layer's attention, kernel "
                      f"vs plain, max|diff| {r['local']:.3e}; end to end kernels vs plain {r['gap']:.3e}, int8 vs "
                      f"fp {r['noise']:.3e} (limit {INT8_NOISE_RATIO:g}x); cosine to the fp tower >= "
                      f"{r['cosine']:.6f}"
                      for d, r in readings["int8"].items()) + f" ({smi})", flush=True)
    print(f"[towers] int8 ViT-L/14@336px, {TOWER_FRAMES} uint8 frames: quantization {q14_s:.4f} s; "
          + "; ".join(f"{d} cold {r['cold_s']:.4f} s, warm {r['warm_s']:.4f} s; each layer's attention, kernel vs "
                      f"plain, max|diff| {r['local']:.3e}; end to end kernels vs plain {r['gap']:.3e}, int8 vs fp "
                      f"{r['noise']:.3e} (limit {INT8_NOISE_RATIO:g}x); cosine to the fp tower >= {r['cosine']:.6f}"
                      for d, r in readings["L14 int8"].items())
          + f"; the phase {time.perf_counter() - phase_start:.1f} s ({smi})", flush=True)
    return launches


def launch_ranks(role: str, spec: dict, ranks: int, tmp: Path, backend: Optional[str]) -> list:
    """``ranks`` processes running ``rank_main(role, spec)``, each its own rank
    on cuda:0 (a group over ``backend``; one process and no backend: no
    group), joined within RANK_TIMEOUT_S; a rank that fails or hangs ends them
    all and fails the phase -> each rank's result, in rank order."""
    import os
    import signal

    tag = f"{role}_{ranks}_{backend or 'alone'}"
    spec = dict(spec, out=str(tmp / tag), rendezvous=f"file://{tmp / (tag + '.rendezvous')}")
    spec_path = tmp / f"{tag}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, LOCAL_RANK="0", ANOMALYCLIP_DIST_TIMEOUT_S=str(RANK_TIMEOUT_S // 2))
    if backend:
        env.update(WORLD_SIZE=str(ranks), CHIP_SMOKE_BACKEND=backend)
    procs, logs = [], []
    for r in range(ranks):
        log = open(tmp / f"{tag}.rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--rank", role, str(spec_path)],
                                      cwd=ROOT, env=dict(env, RANK=str(r)), stdout=log, stderr=subprocess.STDOUT,
                                      start_new_session=True))
    deadline, failed = time.monotonic() + RANK_TIMEOUT_S, None
    try:
        for r, proc in enumerate(procs):
            try:
                if proc.wait(timeout=max(1.0, deadline - time.monotonic())) != 0:
                    failed = failed or f"rank {r} exited {proc.returncode}"
            except subprocess.TimeoutExpired:
                failed = failed or f"rank {r} did not end within {RANK_TIMEOUT_S} s"
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for log in logs:
            log.close()
    if failed:
        for r in range(ranks):
            print(f"[multi] {tag} rank {r} log tail:\n" + (tmp / f"{tag}.rank{r}.log").read_text()[-3000:], flush=True)
        raise AssertionError(f"phase 4k {tag}: {failed}")
    return [json.loads(Path(f"{spec['out']}.rank{r}.json").read_text()) for r in range(ranks)]


def rank_main(role: str, spec_path: str) -> int:
    """One rank of phase 4k (``--rank``): join the group the launcher
    described, run ``role`` under ``deterministic_mode`` with the launch and
    route counts taken in its own window, write the result beside ``out``."""
    import os

    from anomalyclip_tpu_torch.parallel import mesh

    spec = json.loads(Path(spec_path).read_text())
    backend = os.environ.get("CHIP_SMOKE_BACKEND")
    if backend:
        mesh.init_distributed(backend=backend, world_size=int(os.environ["WORLD_SIZE"]),
                              rank=int(os.environ["RANK"]), init_method=spec["rendezvous"])
    with deterministic_mode():
        result = {"fit": rank_fit, "tp": rank_tp}[role](spec)
    result.update(rank=mesh.rank(), ranks=mesh.world_size(),
                  backend=torch.distributed.get_backend() if mesh.distributed() else None)
    Path(f"{spec['out']}.rank{mesh.rank()}.json").write_text(
        json.dumps(result, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))
    if mesh.distributed():
        torch.distributed.destroy_process_group()
    return 0


def leaves_digest(tree) -> str:
    import hashlib

    from anomalyclip_tpu_torch.convert import tree_leaves

    digest = hashlib.sha256()
    for leaf in tree_leaves(tree):
        digest.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()


def rank_fit(spec: dict) -> dict:
    """A rank's training run through ``train_entry.main`` and the eval entry on
    its ``last``, with every step's loss (this rank's), a digest of the
    trainable leaves and BN state at every epoch boundary, each scoring pass's
    per-frame scores and each epoch's seconds recorded -> the readings and the
    launch and route counts of both entries."""
    import anomalyclip_tpu_torch.train.module as train_module
    from anomalyclip_tpu_torch import eval_entry, train_entry

    rec = {"losses": [], "digests": [], "scores": [], "epoch_s": []}
    real_class, real_evaluate = train_module.AnomalyCLIPTrainModule, train_module.evaluate_videos

    class Recorded(real_class):
        def __init__(self, cfg, device=None):
            super().__init__(cfg, device)
            log_metrics = self.loggers.log_metrics

            def logged(metrics, step):
                if "train/epoch_time_s" in metrics:
                    rec["epoch_s"].append(metrics["train/epoch_time_s"])
                log_metrics(metrics, step)

            self.loggers.log_metrics = logged

        def _build_train_step(self):
            step = super()._build_train_step()

            def recorded(*args):
                out = step(*args)
                rec["losses"].append(float(out[2].total))
                return out

            return recorded

        def _boundary(self, state):
            boundary = super()._boundary(state)
            rec["digests"].append(leaves_digest([boundary["trainable"], *boundary["bn_state"]]))
            return boundary

    def evaluated(*args, **kwargs):
        out = real_evaluate(*args, **kwargs)
        rec["scores"].append(out["abnormal_scores"].tolist())
        return out

    train_module.AnomalyCLIPTrainModule, train_module.evaluate_videos = Recorded, evaluated
    try:
        counts_taken()
        torch.cuda.synchronize()
        start = time.perf_counter()
        rec["test"] = train_entry.main(spec["train"])
        rec["evaluated"] = eval_entry.main(spec["eval"]) if spec.get("eval") else None
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - start
        rec["counts"] = counts_taken()
    finally:
        train_module.AnomalyCLIPTrainModule, train_module.evaluate_videos = real_class, real_evaluate
    return rec


def rank_tp(spec: dict) -> dict:
    """A rank's ``predict.main`` on TP_FRAMES seeded frames, once a dtype, with the
    launch and route counts and the (L, heads, width) of every K1 launch taken
    in its own window, then one ``score_input`` of a module built as the CLI
    builds it, timed in the process the CLI warmed -> the scores."""
    from anomalyclip_tpu_torch import predict
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.models.clip import model as clip_model

    frames = np.load(spec["frames"])
    real_k1, k1_shapes = clip_model.fused_mha_qkv, []

    def k1(qkv, num_heads, causal=False):
        k1_shapes.append((qkv.shape[1], num_heads, qkv.shape[2]))
        return real_k1(qkv, num_heads, causal)

    out = {}
    clip_model.fused_mha_qkv = k1
    try:
        for dtype in spec["dtypes"]:
            args = spec["predict"] + [f"model.net.compute_dtype={dtype}", "extras.print_config=False"]
            with seeded_decode(frames):
                k1_shapes.clear()
                counts_taken()
                torch.cuda.synchronize()
                start = time.perf_counter()
                result = predict.main(args + [f"input={spec['video']}"])
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - start
                counts, shapes = counts_taken(), sorted(set(k1_shapes))
            module, state = predict.load_module_and_state(to_dict(compose(default_config_dir(), "eval", args)), "cuda")
            # one scoring call in the process predict.main warmed
            torch.cuda.synchronize()
            start = time.perf_counter()
            predict.score_input(module, state, frames, spec["video"])
            torch.cuda.synchronize()
            out[dtype] = dict(scores=result["frame_scores"], counts=counts, k1_shapes=shapes, cli_s=cli_s,
                              warm_s=time.perf_counter() - start, tp=bool(getattr(module._encode_fn(), "tp", False)))
            del module, state
    finally:
        clip_model.fused_mha_qkv = real_k1
    return out


def phase_multi(smi: str, frames_root: Path, annotations: Path, kept: Path) -> dict:
    """Phase 4k: more than one device, every rank a process on the one card
    -> the kernel launch and route counts of each rank of its main path."""
    import os

    saved = {k: os.environ.get(k) for k in ("UCFCRIME_ROOT", "ANOMALYCLIP_NO_DOWNLOAD")}
    try:
        with tempfile.TemporaryDirectory(prefix="multi_", dir=ROOT / "build") as tmp:
            tmp = Path(tmp)
            ucf_data_root(tmp, frames_root, annotations)
            return run_multi(smi, tmp, kept / "ViT-B-16.pt")
    finally:
        restore_env(saved)


def run_multi(smi: str, tmp: Path, clip_path: Path) -> dict:
    """Phase 4k's runs; see the module docstring."""
    from anomalyclip_tpu_torch import predict
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig

    phase_start = time.perf_counter()
    cfg = CLIPConfig.vit_b16()
    common = [f"model.net.clip_ckpt_path={clip_path}", "extras.print_config=False"]

    def fit_spec(name: str, epochs: int) -> dict:
        log_dir = tmp / name
        run = log_dir / "train" / "runs" / "ucfcrime"
        return {"train": ["experiment=ucfcrime", *common, f"trainer.max_epochs={epochs}",
                          "model.net.select_idx_dropout_topk=0.0", "model.net.select_idx_dropout_bottomk=0.0",
                          "logger=csv", f"paths.log_dir={log_dir}"],
                "eval": ["data=ucfcrime", "model=anomaly_clip_ucfcrime", *common,
                         f"ckpt_path={run / 'checkpoints' / 'last'}", f"paths.log_dir={tmp / (name + '_eval')}"]}

    # ---- (a) data parallel: one process, then DP_RANKS ranks over gloo
    one = launch_ranks("fit", fit_spec("one", ENTRY_EPOCHS), 1, tmp, None)[0]
    dp = launch_ranks("fit", fit_spec("dp", ENTRY_EPOCHS), DP_RANKS, tmp, "gloo")
    steps = len(one["losses"])
    videos = 16
    require(steps == ENTRY_EPOCHS * 8 and len(one["scores"]) == ENTRY_EPOCHS + 2, f"one process: {steps} steps, "
            f"{len(one['scores'])} scoring passes")

    def expected(ranks: int) -> dict:
        """A rank's launches: K1 12 a step and a scoring pass (the text
        features), K3 12 a step, K2 two a step and a video it scores, K4 two a
        step; every one on its fp32 route."""
        k1, k3 = cfg.transformer_layers * (steps + ENTRY_EPOCHS + 2), cfg.transformer_layers * steps
        k2, k4 = 2 * (steps + videos // ranks * (ENTRY_EPOCHS + 2)), 2 * steps
        return {"fused_mha_qkv": k1, "mha_tf32": k1, "mha_qkv_bwd": k3, "whole_bwd_tf32": k3,
                "fused_mha_bld": k2, "bld_tf32": k2, "mha_bld_bwd": k4, "bld_bwd_tf32": k4}

    held("4k one process", one["counts"], expected(1))
    for r, got in enumerate(dp):
        require(got["rank"] == r and got["ranks"] == DP_RANKS and got["backend"] == "gloo", f"rank {r}: {got}")
        held(f"4k data-parallel rank {r}", got["counts"], expected(DP_RANKS))
        require(got["digests"] == dp[0]["digests"] and len(got["digests"]) == ENTRY_EPOCHS,
                f"rank {r}'s parameters differ from rank 0's at an epoch boundary")
    losses = np.mean([got["losses"] for got in dp], axis=0)  # the global loss: the ranks' mean
    loss_gap = float(np.max(np.abs(losses - one["losses"]) / np.abs(one["losses"])))
    require(loss_gap <= DP_LOSS_RTOL, f"data-parallel losses vs one process: relative gap {loss_gap:.3e}")
    metric_gap = max(abs(got[part][k] - one[part][k]) for got in dp for part in ("test", "evaluated")
                     for k in EVAL_METRICS[:4])
    require(metric_gap <= DP_TOL, f"data-parallel metrics vs one process: max|diff| {metric_gap:.3e}")
    score_gap = 0.0
    for got in dp:
        for want, mine in zip(one["scores"], got["scores"], strict=True):
            score_gap = max(score_gap, float(np.max(np.abs(np.asarray(mine) - np.asarray(want)))))
    require(score_gap <= DP_TOL, f"data-parallel per-video scores vs one process: max|diff| {score_gap:.3e}")
    val_gap = 0.0
    for epoch in range(ENTRY_EPOCHS):
        with open(tmp / "one" / "train" / "runs" / "ucfcrime" / f"metrics_{epoch}.json") as f, \
                open(tmp / "dp" / "train" / "runs" / "ucfcrime" / f"metrics_{epoch}.json") as g:
            a, b = json.load(f), json.load(g)
        val_gap = max(val_gap, max(abs(a[k] - b[k]) for k in EVAL_METRICS[:4]))
    require(val_gap <= DP_TOL, f"data-parallel validation metrics vs one process: max|diff| {val_gap:.3e}")

    # ---- (c) a one-rank NCCL group: the same DP code, to the bit
    nccl = launch_ranks("fit", fit_spec("nccl", ENTRY_EPOCHS), 1, tmp, "nccl")[0]
    require(nccl["backend"] == "nccl" and nccl["ranks"] == 1, f"the NCCL run: {nccl['backend']}, {nccl['ranks']}")
    held("4k one-rank NCCL group", nccl["counts"], expected(1))
    for key in ("losses", "digests", "scores", "test", "evaluated"):
        first = next((i for i, (a, b) in enumerate(zip(nccl[key], one[key])) if a != b), None) \
            if isinstance(one[key], list) else None
        require(nccl[key] == one[key], f"the one-rank NCCL run's {key} differ from the run without a group "
                                       f"(first at {first}: {nccl[key][first] if first is not None else ''} vs "
                                       f"{one[key][first] if first is not None else ''})"[:2000])

    # ---- (b) the tensor-parallel tower from frames, fp32 and bf16
    frames = np.random.default_rng(SEED + 5).integers(0, 256, (1, TP_FRAMES, 224, 224, 3), dtype=np.uint8)
    np.save(tmp / "frames.npy", frames)
    video = tmp / SEEDED_VIDEO
    video.touch()
    run = tmp / "one" / "train" / "runs" / "ucfcrime" / "checkpoints" / "last"
    predict_args = ["data=ucfcrime", "model=anomaly_clip_ucfcrime", *common, f"ckpt_path={run}",
                    f"paths.log_dir={tmp / 'predict'}"]
    dtypes = ("float32", "bfloat16")
    tp = launch_ranks("tp", {"frames": str(tmp / "frames.npy"), "video": str(video), "dtypes": dtypes,
                             "predict": predict_args + [f"trainer.model_parallel={TP_RANKS}"]}, TP_RANKS, tmp, "gloo")
    chunks = -(-(-(-TP_FRAMES // (32 * 16)) * 32 * 16) // 256)
    k1 = cfg.transformer_layers + cfg.vision_layers * chunks
    heads = cfg.vision_heads // TP_RANKS
    tp_lines = []
    for dtype in dtypes:
        # the single tower: this process, no group, out of every rank's window
        args = predict_args + [f"model.net.compute_dtype={dtype}", "extras.print_config=False"]
        with seeded_decode(frames):
            want = np.asarray(predict.main(args + [f"input={video}"])["frame_scores"])
        module, state = predict.load_module_and_state(to_dict(compose(default_config_dir(), "eval", args)), "cuda")
        torch.cuda.synchronize()  # one scoring call, as on each rank
        start = time.perf_counter()
        predict.score_input(module, state, frames, str(video))
        torch.cuda.synchronize()
        single_s = time.perf_counter() - start
        del module, state
        route, gaps = ("mha_tf32" if dtype == "float32" else "mha_tc"), []
        for r, got in enumerate(tp):
            mine = got[dtype]
            require(mine["tp"], f"rank {r} {dtype}: the module did not take the tensor-parallel tower")
            held(f"4k tensor-parallel rank {r} {dtype}", mine["counts"],
                 {"fused_mha_qkv": k1, route: k1, "fused_mha_bld": 2, "bld_tf32": 2})
            image = [s for s in mine["k1_shapes"] if s[0] == cfg.grid_size ** 2 + 1]
            require(image == [[cfg.grid_size ** 2 + 1, heads, 3 * heads * 64]],
                    f"rank {r} {dtype}: the image tower's K1 launches ran {image}, not {heads} local heads")
            gaps.append(float(np.max(np.abs(np.asarray(mine["scores"]) - want))))
            require(gaps[-1] <= TP_TOL[dtype], f"rank {r} {dtype}: TP scores vs the single tower max|diff| "
                                              f"{gaps[-1]:.3e}")
        tp_lines.append(f"{dtype} score_input on the TP tower {tp[0][dtype]['warm_s']:.3f} s (the CLI with its "
                        f"set-up {tp[0][dtype]['cli_s']:.3f} s) vs the single tower {single_s:.3f} s "
                        f"(max|diff| {max(gaps):.3e})")

    print(f"[multi] data parallel, {DP_RANKS} gloo ranks sharing the one card (time-slicing and the collectives, "
          f"not scaling): epochs {', '.join(f'{x:.3f}' for x in dp[0]['epoch_s'])} s vs one process "
          f"{', '.join(f'{x:.3f}' for x in one['epoch_s'])} s; both entries {dp[0]['seconds']:.2f} s vs "
          f"{one['seconds']:.2f} s; losses within {loss_gap:.3e} relative, metrics {metric_gap:.3e}, "
          f"validation {val_gap:.3e}, per-video scores {score_gap:.3e}; the ranks' parameters equal to the bit "
          f"at every epoch ({smi})", flush=True)
    print(f"[multi] a one-rank NCCL group: {ENTRY_EPOCHS} epochs and both entries equal to the run without a "
          f"group to the bit (losses, parameters, scores, metrics); epochs "
          f"{', '.join(f'{x:.3f}' for x in nccl['epoch_s'])} s ({smi})", flush=True)
    print(f"[multi] tensor parallel, model_parallel={TP_RANKS} on {TP_RANKS} gloo ranks sharing the one card, "
          f"{TP_FRAMES} uint8 frames, {heads} heads a rank on K1: " + "; ".join(tp_lines)
          + f"; the phase {time.perf_counter() - phase_start:.1f} s ({smi})", flush=True)
    return {"one": one["counts"], **{f"dp{r}": got["counts"] for r, got in enumerate(dp)}, "nccl": nccl["counts"],
            **{f"tp{r} {d}": got[d]["counts"] for r, got in enumerate(tp) for d in dtypes}}


def phase_orbax(smi: str) -> dict:
    """Phase 4l: the committed Orbax checkpoints of the JAX package, read,
    evaluated, resumed and converted -> the kernel launch and route counts of
    its main path."""
    import os

    saved = {k: os.environ.get(k) for k in ("SYNTHETIC_ROOT", "LOG_DIR", "ANOMALYCLIP_NO_DOWNLOAD")}
    try:
        with tempfile.TemporaryDirectory(prefix="orbax_", dir=ROOT / "build") as tmp:
            return run_orbax(smi, Path(tmp))
    finally:
        restore_env(saved)


def run_orbax(smi: str, tmp: Path) -> dict:
    """Phase 4l's runs; see the module docstring."""
    import csv
    import hashlib
    import importlib.util
    import os
    import shutil

    from anomalyclip_tpu_torch import eval_entry, train_entry
    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict
    from anomalyclip_tpu_torch.convert import tree_leaves
    from anomalyclip_tpu_torch.convert_ckpt import main as convert_main
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig
    from anomalyclip_tpu_torch.train import orbax_reader
    from anomalyclip_tpu_torch.train.checkpoint import restore_state
    from anomalyclip_tpu_torch.train.module import METRIC_NAMES

    phase_start = time.perf_counter()
    record = json.loads((ORBAX_FIXTURE / "fixture.json").read_text())
    shutil.copytree(ORBAX_FIXTURE, tmp / "fixture")
    last = tmp / "fixture" / "fit" / "checkpoints" / "last"
    last.symlink_to("epoch_000")
    dirs = {"fit": last, "converted": tmp / "fixture" / "converted"}

    # (a) the reader, with no JAX, orbax or compression package
    zstandard_importable = importlib.util.find_spec("zstandard") is not None
    on_disk = sum(f.stat().st_size for d in dirs.values() for f in d.resolve().rglob("*") if f.is_file())
    start = time.perf_counter()
    leaves = {name: orbax_reader.read_leaves(path) for name, path in dirs.items()}
    read_s = time.perf_counter() - start
    loaded = [m for m in ORBAX_FORBIDDEN if m in sys.modules]
    require(not loaded, f"reading the Orbax fixture loaded {loaded}")
    decoded = 0
    for name, got in leaves.items():
        want = record["leaves"][name]
        require(len(got) == len(want), f"{name}: {len(got)} leaves read, the JSON lists {len(want)}")
        for keys, (array, dtype_name) in got.items():
            entry = want["/".join(k for k, _ in keys)]
            require(dtype_name == entry["dtype"], f"{name} {keys}: dtype {dtype_name}, the JSON says {entry}")
            if array is not None:
                digest = hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()
                require(digest == entry["sha256"] and list(array.shape) == entry["shape"],
                        f"{name} {keys}: its sha256 or shape differs from the JSON's")
                decoded += array.nbytes
    print(f"[4l] read {sum(len(g) for g in leaves.values())} leaves of the Orbax fixture in {read_s:.3f} s: "
          f"{on_disk / read_s / 1e6:.2f} MB/s on disk, {decoded / read_s / 1e6:.2f} MB/s decoded "
          f"({on_disk} B, {decoded} B); loaded afterwards of {ORBAX_FORBIDDEN}: none; zstandard importable "
          f"here: {zstandard_importable} [{smi}]")

    # the seeded CLIP the fixture was trained with, and the synthetic set
    clip_cfg = CLIPConfig(**record["clip"]["config"])
    clip_path = tmp / "clip.pt"
    torch.save(seeded_clip_state_dict(clip_cfg, record["clip"]["seed"]), clip_path)
    os.environ.update(SYNTHETIC_ROOT=str(tmp / "synthetic"), ANOMALYCLIP_NO_DOWNLOAD="1")
    common = [*record["overrides"], f"model.net.clip_ckpt_path={clip_path}", "extras.print_config=False"]
    data_cfg = to_dict(compose(default_config_dir(), "train", ["experiment=synthetic", *common]))["data"]
    videos, depth = int(data_cfg["synthetic_num_test"]), 1
    layers = clip_cfg.transformer_layers
    counts = {}

    def window(what: str, fn, steps: int, passes: int) -> float:
        """``fn`` with the counts set to 0 just before and read just after,
        held exactly: K1 a text-tower forward a step and a scoring pass, K3 a
        step, K2 two a layer of the temporal model a step and a video scored,
        K4 two a layer a step, each on its fp32 route -> its seconds."""
        counts_taken()
        torch.cuda.synchronize()
        begin = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - begin
        k1, k3 = layers * (steps + passes), layers * steps
        k2, k4 = 2 * depth * (steps + videos * passes), 2 * depth * steps
        counts[what] = held(f"4l {what}", counts_taken(), {
            "fused_mha_qkv": k1, "mha_tf32": k1, "mha_qkv_bwd": k3, "whole_bwd_tf32": k3,
            "fused_mha_bld": k2, "bld_tf32": k2, "mha_bld_bwd": k4, "bld_bwd_tf32": k4})
        return seconds

    # (b) the eval entry on the JAX run's last
    os.environ["LOG_DIR"] = str(tmp / "eval_logs")
    metrics = {}
    eval_s = window("eval_entry", lambda: metrics.update(eval_entry.main(
        ["data=synthetic", "model=anomaly_clip_synthetic", "seed=1024", *common, f"ckpt_path={last}"])),
        steps=0, passes=1)
    gap = max(abs(float(metrics[k]) - record["jax_test_metrics"][k]) for k in EVAL_METRICS[:4])
    require(gap <= ORBAX_METRIC_TOL, f"4l eval of the Orbax last vs the JAX eval: max|diff| {gap:.3e}")

    # (d) the converter on last, then (c) one epoch resumed from each
    start = time.perf_counter()
    convert_main([str(last), str(tmp / "state")])
    convert_s = time.perf_counter() - start
    want, got = restore_state(last), restore_state(tmp / "state")
    require(all(torch.equal(a, b) for a, b in zip(tree_leaves(want["trainable"]), tree_leaves(got["trainable"])))
            and (got["step"], got["epoch"], got["count"]) == (want["step"], want["epoch"], want["count"]),
            "4l: convert_ckpt's state.pt differs from the Orbax state")
    steps_per_epoch = int(want["count"]) // (int(want["epoch"]) + 1)
    resumed = {}
    for name, ckpt in (("orbax", last), ("state_pt", tmp / "state")):
        log_dir = tmp / f"resume_{name}"
        os.environ["LOG_DIR"] = str(log_dir)
        with deterministic_mode():
            seconds = window(f"resume from {name}", lambda ckpt=ckpt: train_entry.main(
                ["experiment=synthetic", *common, "trainer.max_epochs=2", f"ckpt_path={ckpt}"]),
                steps=steps_per_epoch, passes=2)
        run = log_dir / "train" / "runs" / "synthetic"
        rows = [r for r in csv.DictReader(open(run / "csv" / "metrics.csv")) if r.get("train/loss")]
        require([int(r["step"]) for r in rows] == [1], f"4l resume from {name}: epochs {[r['step'] for r in rows]}")
        final = restore_state(run / "checkpoints" / "last")
        resumed[name] = SimpleNamespace(losses={k: float(rows[0][k]) for k in METRIC_NAMES}, seconds=seconds,
                                        trainable=tree_leaves(final["trainable"]), epoch=final["epoch"])
    a, b = resumed["orbax"], resumed["state_pt"]
    require(a.epoch == b.epoch == 1, f"4l: the resumed runs end at epochs {a.epoch}, {b.epoch}")
    require(a.losses == b.losses and all(torch.equal(x, y) for x, y in zip(a.trainable, b.trainable)),
            "4l: the resume from the Orbax directory and from its state.pt differ")
    loss_gap = max(abs(a.losses[k] - v) / abs(v) for k, v in record["jax_resumed_losses"].items())
    require(loss_gap <= ORBAX_LOSS_RTOL, f"4l resumed losses vs the JAX resume: relative gap {loss_gap:.3e}")
    print(f"[4l] eval_entry on the Orbax last {eval_s:.2f} s (metrics vs JAX max|diff| {gap:.3e}); "
          f"convert_ckpt {convert_s:.3f} s; one epoch resumed from the Orbax last {a.seconds:.2f} s, from its "
          f"state.pt {b.seconds:.2f} s (equal to the bit; losses vs JAX relative gap {loss_gap:.3e}); "
          f"phase {time.perf_counter() - phase_start:.1f} s [{smi}]")
    totals = defaultdict(int)
    for got in counts.values():
        for k, v in got.items():
            totals[k] += v
    print(f"[4l] launches: {({w: {k: v for k, v in c.items() if v} for w, c in counts.items()})}")
    return dict(totals)


def kernel_class(name: str) -> str:
    low = name.lower()
    if "mha_tc_kernel" in low:
        return "attention (mha_tc.cu)"
    if "mha_tf32_kernel" in low:
        return "attention (mha_tf32.cu)"
    if "mha_bld_tf32" in low:
        return "attention (mha_bld_tf32.cu)"
    if "mha_whole_tf32" in low:
        return "attention backward (mha_whole_tf32_bwd.cu)"
    if "mha_fwd_kernel" in low:
        return "attention (mha.cu)"
    if "probe_kernel" in low or "parts_kernel" in low:
        return "attention (mha_probe.cu)"
    if "flash_fwd_kernel" in low:
        return "attention (mha_long.cu)"
    if "mha_bwd_kernel" in low:
        return "attention backward (mha_bwd.cu)"
    if "blocked_dq_tc_kernel" in low or "blocked_dkv_tc_kernel" in low:
        return "attention backward (mha_tc_bwd.cu)"
    if "blocked_dq_tf32_kernel" in low or "blocked_dkv_tf32_kernel" in low:
        return "attention backward (mha_tf32_bwd.cu)"
    if "blocked_dq_kernel" in low or "blocked_dkv_kernel" in low:
        return "attention backward (mha_blocked_bwd.cu)"
    if low.startswith(("memcpy", "memset")):
        return "copies"
    # cuDNN's convolutions, with the FFT passes, the complex GEMMs they call
    # and their layout conversions
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "fft", "cf32")):
        return "convolutions (cuDNN)"
    if "gemm" in low or "nvjet" in low or "gemv" in low:
        return "GEMM"
    return "elementwise and reductions"


def profile_call(fn, top: int = 15, warm: int = 3) -> dict:
    """``warm`` warm calls of fn on the host clock, then one under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(warm):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name, e.time_range.elapsed_us() / 1e3)
              for e in prof.events() if e.device_type == cuda]
    require(bool(events), "torch.profiler recorded no device time")
    by_kernel, by_class = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for name, ms in events:
        by_kernel[name][0] += ms
        by_kernel[name][1] += 1
        by_class[kernel_class(name)] += ms
    device_ms = sum(ms for _, ms in events)
    return {
        "wall_s": walls,
        "profiled_wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n, "ms": ms, "count": c} for n, (ms, c)
                        in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top]],
    }


def print_profile(what: str, r: dict) -> None:
    print(f"[profile] {what}: warm walls (s) {', '.join(f'{w:.4f}' for w in r['wall_s'])}; "
          f"profiled call device {r['device_ms']:.1f} ms of wall {r['profiled_wall_ms']:.1f} ms "
          f"({100 * r['busy_share']:.1f}% busy)")
    for cls, ms in r["by_class_ms"].items():
        print(f"[profile] {what}   {cls:32s} {ms:9.2f} ms {100 * ms / r['device_ms']:5.1f}%")
    for k in r["top_kernels"]:
        print(f"[profile] {what}   {k['ms']:9.2f} ms n={k['count']:5d} {k['name'][:100]}")


def phase_profile(out: Path, smi: str) -> None:
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP
    from anomalyclip_tpu_torch.models.losses import LossConfig
    from anomalyclip_tpu_torch.models.selector import BNState
    from anomalyclip_tpu_torch.predict import Predictor
    from anomalyclip_tpu_torch.train.module import (
        build_train_step,
        init_state,
        prepare_batch,
        zero_metric_sums,
    )

    model, frozen, trainable, bn_state, ncentroid = build_ucf_model("cuda")
    frames = np.random.default_rng(SEED).integers(
        0, 256, (1, CHECK_VIDEO, 224, 224, 3), dtype=np.uint8
    )
    results = {"card": smi, "frames": CHECK_VIDEO}
    for dtype in ("float32", "bfloat16"):
        m = AnomalyCLIP(dataclasses.replace(model.cfg, compute_dtype=dtype),
                        model.clip_cfg, model.classnames, model.prompt_spec)
        predictor = Predictor(m, frozen, trainable, bn_state, ncentroid, device="cuda",
                              sampling=ucf_sampling())
        results[dtype] = profile_call(lambda: predictor.score_frames(frames))
        print_profile(f"{dtype} {CHECK_VIDEO} frames", results[dtype])

    # one warm 256-frame encode chunk per dtype: the ViT-B/16 tower fp and
    # int8 on the same weights, and RN50 from seeded weights
    from anomalyclip_tpu_torch.convert import tree_to
    from anomalyclip_tpu_torch.models.clip import quant
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, encode_image, init_clip_params

    chunk = torch.from_numpy(frames[0, :256]).cuda()
    qvisual = quant.quantize_clip_visual(frozen["clip"])
    rn50 = tree_to({"visual": init_clip_params(torch.Generator().manual_seed(SEED + 7), CLIPConfig.rn50())["visual"]},
                   "cuda")
    towers = {"vit_b16": lambda dt: encode_image(frozen["clip"], model.clip_cfg, chunk, dt),
              "int8_vit_b16": lambda dt: quant.encode_image_int8(qvisual, model.clip_cfg, chunk, dt),
              "rn50": lambda dt: encode_image(rn50, CLIPConfig.rn50(), chunk, dt)}
    for tower, fn in towers.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{tower}_chunk_{str(dtype).split('.')[-1]}"
            with torch.no_grad():
                results[key] = profile_call(lambda: fn(dtype))
            print_profile(f"{tower} {str(dtype).split('.')[-1]}, one 256-frame chunk", results[key])
    del qvisual, rn50, chunk

    # one warm UCF-Crime training step from features, fp32, batch 64, with the
    # host-to-device copy of the batch
    train_model = AnomalyCLIP(dataclasses.replace(model.cfg, load_from_features=True),
                              model.clip_cfg, model.classnames, model.prompt_spec)
    state = init_state(trainable, BNState.create(len(model.classnames) - 1).to("cuda"),
                       SOLVER, OPTIMIZER, SCHEDULER, steps_per_epoch=1)
    train_step = build_train_step(
        train_model,
        LossConfig(normal_id=NORMAL_ID, num_topk=3, frames_per_segment=16, num_segments=32),
    )
    batch = make_train_batches(np.random.default_rng(SEED), model.clip_cfg.embed_dim)[0]
    gen = torch.Generator().manual_seed(SEED)
    holder = [state]

    def step():
        holder[0], _, _ = train_step(frozen, holder[0], prepare_batch(batch, "cuda"),
                                     ncentroid.to("cuda"), gen, zero_metric_sums("cuda"))

    results["train_step_float32"] = profile_call(step)
    print_profile("fp32 train step, batch 64", results["train_step_float32"])
    del model, frozen, trainable, predictor, m, train_model, state, holder
    torch.cuda.empty_cache()

    # one warm ViT-L/14@336px scoring call of the 200-frame video per dtype
    model, frozen, trainable, bn_state, ncentroid = build_ucf_model("cuda", arch="ViT-L/14@336px")
    frames = l14_video()
    for dtype in ("float32", "bfloat16"):
        m = AnomalyCLIP(dataclasses.replace(model.cfg, compute_dtype=dtype),
                        model.clip_cfg, model.classnames, model.prompt_spec)
        predictor = Predictor(m, frozen, trainable, bn_state, ncentroid, device="cuda",
                              sampling=ucf_sampling())
        key = f"l14_336_{dtype}"
        results[key] = profile_call(lambda: predictor.score_frames(frames), warm=1)
        print_profile(f"ViT-L/14@336px {dtype} {L14_VIDEO_FRAMES} frames", results[key])
    del model, frozen, trainable, predictor, m
    torch.cuda.empty_cache()

    # one warm forward+backward step of the ViT-L/14@336px tower per dtype
    _, _, step = tower_gradient_setup("ViT-L/14@336px")
    for dtype in (torch.float32, torch.bfloat16):
        key = f"l14_336_gradient_{str(dtype).split('.')[-1]}"
        results[key] = profile_call(lambda: step(dtype), warm=1)
        print_profile(f"ViT-L/14@336px gradient {key.rsplit('_', 1)[-1]} batch {GRAD_BATCH}", results[key])
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"[profile] wrote {out}")
    torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", type=Path, metavar="OUT.json",
                        help="also profile one warm 700-frame call per dtype, one warm "
                             "256-frame encode chunk of the ViT-B/16, int8 and RN50 towers "
                             "per dtype, one warm training step, one warm ViT-L/14@336px call "
                             "per dtype and one warm step of its tower's gradient per dtype")
    parser.add_argument("--rank", nargs=2, metavar=("ROLE", "SPEC"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank:  # one rank of phase 4k, started by launch_ranks
        return rank_main(*args.rank)
    smi = phase_device()
    phase_build()
    report = {}
    phase_kernels(report)
    phase_bwd_kernels(report)
    phase_long_bwd_kernels(report)
    phase_small_and_causal()
    phase_probe_kernels(report)
    slice_launches, slice16_launches = phase_slice()
    train_launches = phase_train()
    l14_launches = phase_l14()
    grad_launches = phase_tower_gradient()
    script_launches = phase_scripts()
    # one feature set on disk for phases 4f, 4g and 4h, removed at the end
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="feature_set_", dir=ROOT / "build") as tmp:
        feature_set = make_feature_set(Path(tmp))
        data_launches = phase_data(smi, *feature_set)
        fit_launches = phase_fit(smi, *feature_set)
        entry_launches = phase_entry(smi, *feature_set, Path(tmp))
        serving_launches = phase_serving(smi, *feature_set, Path(tmp))
        tower_launches = phase_towers(smi, *feature_set, Path(tmp))
        multi_launches = phase_multi(smi, *feature_set, Path(tmp))
    orbax_launches = phase_orbax(smi)
    if args.profile:
        phase_profile(args.profile, smi)
    # each path ran its kernels: the forwards on both, the backwards on training,
    # the flash kernel through fused_attention's routing in the fp32
    # ViT-L/14@336px tower, the q-tiled kernel in the bf16 one, and each one's
    # backward in the tower's gradient
    require(all(slice_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_tf32", "bld_tf32")),
            f"a kernel of the scoring path was never launched: {slice_launches}")
    require(all(slice16_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_tc", "bld_tf32")),
            f"a kernel of the bf16 scoring path was never launched: {slice16_launches}")
    l14_paths = {"float32": ("fused_mha_qkv", "fused_mha_bld", "flash_attention_heads", "mha_tf32",
                             "bld_tf32"),
                 "bfloat16": ("fused_mha_qkv", "fused_mha_bld", "fused_mha_qtile", "mha_tc", "bld_tf32")}
    for dtype, names in l14_paths.items():
        require(all(l14_launches[dtype][k] > 0 for k in names),
                f"a kernel of the {dtype} ViT-L/14@336px path was never launched: "
                f"{l14_launches[dtype]}")
    require(all(train_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd",
                                                "mha_bld_bwd", "mha_tf32", "bld_tf32", "bld_bwd_tf32",
                                                "whole_bwd_tf32")),
            f"a kernel of the training path was never launched: {train_launches}")
    grad_paths = {"ViT-L/14@336px bfloat16": ("fused_mha_qtile", "mha_qtile_bwd", "mha_tc",
                                              "blocked_bwd_tc"),
                  "ViT-L/14@336px float32": ("flash_attention_heads", "flash_dq", "flash_dkv",
                                             "mha_tf32", "blocked_bwd_tf32"),
                  "ViT-B/16 float32": ("fused_mha_qkv", "mha_qkv_bwd", "mha_tf32", "blocked_bwd_tf32")}
    for run, names in grad_paths.items():
        require(all(grad_launches[run][k] > 0 for k in names),
                f"a kernel of the {run} gradient path was never launched: {grad_launches[run]}")
    # and the scripts' path ran every probe kernel and, again, K1-K4, K6-K8
    script_totals = {k: sum(run[k] for run in script_launches) for k in script_launches[0]}
    script_path = (*PROBE_REPLACES, "fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd",
                   "fused_mha_qtile", "flash_attention_heads", "mha_tc", "mha_qtile_bwd",
                   "blocked_bwd_tc", "mha_tf32", "blocked_bwd_tf32", "bld_tf32", "bld_bwd_tf32",
                   "whole_bwd_tf32")
    require(all(script_totals[k] > 0 for k in script_path),
            f"a kernel of the scripts' path was never launched: {script_totals}")
    # the data layer's path: training from disk and whole-set evaluation
    require(all(data_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd",
                                               "mha_tf32", "bld_tf32", "bld_bwd_tf32", "whole_bwd_tf32")),
            f"a kernel of the data and evaluation path was never launched: {data_launches}")
    # the training run's path: fit, validation, checkpoints, resume, test, the
    # from-frames ncentroid
    require(all(fit_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd",
                                              "mha_tf32", "bld_tf32", "bld_bwd_tf32", "whole_bwd_tf32")),
            f"a kernel of the training run's path was never launched: {fit_launches}")
    # the command line's path: the train and eval entries, a search, a multirun
    require(all(entry_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd",
                                                "mha_tf32", "bld_tf32", "bld_bwd_tf32", "whole_bwd_tf32")),
            f"a kernel of the entry points' path was never launched: {entry_launches}")
    # the serving surface: predict, serve, the artifact, extraction (fp32) and
    # the graft entry (bf16)
    require(all(serving_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_tf32", "mha_tc",
                                                  "bld_tf32")),
            f"a kernel of the serving path was never launched: {serving_launches}")
    # the other two towers: RN50's text tower and temporal model, the int8
    # towers' K1 (ViT-B/16), K8 (ViT-L/14@336px fp32) and K6 (bf16)
    require(all(tower_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "fused_mha_qtile",
                                                "flash_attention_heads", "mha_tf32", "mha_tc", "bld_tf32")),
            f"a kernel of the RN50 and int8 towers' path was never launched: {tower_launches}")
    # more than one device: every rank of the data-parallel runs launched K1-K4,
    # every rank of the tensor-parallel tower K1 and K2
    for run, counts in multi_launches.items():
        names = ("fused_mha_qkv", "fused_mha_bld") if run.startswith("tp") else (
            "fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd")
        require(all(counts[k] > 0 for k in names), f"a kernel of the multi-device path ({run}) was never launched: "
                                                   f"{counts}")
    # the JAX package's Orbax checkpoints: evaluated through K1 and K2, resumed
    # through K1-K4
    require(all(orbax_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd",
                                                "mha_tf32", "bld_tf32", "bld_bwd_tf32", "whole_bwd_tf32")),
            f"a kernel of the Orbax checkpoints' path was never launched: {orbax_launches}")
    all_runs = [slice_launches, slice16_launches, train_launches, *l14_launches.values(), *grad_launches.values(),
                *script_launches, data_launches, fit_launches, entry_launches, serving_launches, tower_launches,
                *multi_launches.values(), orbax_launches]
    sources = {**KERNEL_SOURCE, **dict.fromkeys(PROBE_REPLACES, PROBE_SOURCE)}
    replaces = {**REPLACES, **{k: sites[0] for k, sites in PROBE_REPLACES.items()}}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "also_replaces": ALSO_REPLACES.get(name) or PROBE_REPLACES.get(name, [None])[1:],
            "launches": sum(run.get(name, 0) for run in all_runs),
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
            "bound_ms": report[name]["bound_ms"],
            "bound_by": report[name]["bound_by"],
            "library_ms": report[name]["library_ms"],
            "sdpa_ms": report[name]["library_ms"],
            "library_fwd_ms": report[name]["library_fwd_ms"],
        }
        for name in sources
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
