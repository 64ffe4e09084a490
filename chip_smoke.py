"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--profile OUT.json]

Phases, each ending in torch.cuda.synchronize(); any failure raises and the
script exits non-zero without printing a result:

1. device: require CUDA and print the card's name and power limit;
2. build: compile the CUDA kernels from the repository's sources;
3. kernels: each forward kernel against its plain PyTorch version at the main
   paths' shapes, fp32 within 1e-5 and bf16 within 5e-2 (absolute), with median
   times;
3b. backward kernels: K3 and K4 against their plain backwards at the training
   step's shapes, fp32 within 1e-5 and bf16 within 5e-2 of max|ref|, with
   median times;
4. slice: the UCF-Crime ViT-B/16 model at full width from seeded weights scores
   three synthetic uint8 videos (about 200, 700 and 1600 frames) through
   ``Predictor.score_frames`` in fp32; the kernel launch counts of that run are
   checked; the 700-frame video is held against the same call with the plain
   attention (fp32 within 1e-4, absolute), and a bf16 pass against its own
   plain-attention pass (within BF16_SLICE_TOL, absolute);
4b. training: the UCF-Crime training step from features at full width in fp32
   (batch 64: 32 abnormal and 32 normal videos of 512 x 512-d features), three
   steps through ``fit_steps`` with one step per epoch, so that epoch 0 trains
   at lr 0 and epoch 1 moves the weights; the kernel launch counts of that run
   are checked, and the same steps under the plain attention must agree: step
   1's loss terms and gradients within 1e-4 of each leaf's max, the 3-step
   losses at rtol 5e-4, the BN state within 1e-5;
5. profile (only with --profile): for fp32 and bf16, three warm calls of the
   700-frame video on the host clock, then one under torch.profiler, and the
   same for one warm training step: device time against wall time, time by
   class of kernel and the top kernels, printed and written as JSON to
   OUT.json.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts (the scoring and training runs together),
errors and times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
# video length -> the 32x16-frame grids that cover it (buckets 1, 2 and 4)
VIDEO_GRIDS = {200: 1, 700: 2, 1600: 4}
VIDEO_FRAMES = tuple(VIDEO_GRIDS)
CHECK_VIDEO = 700
KERNEL_SOURCE = {
    "fused_mha_qkv": "anomalyclip_tpu_torch/ops/csrc/mha.cu",
    "fused_mha_bld": "anomalyclip_tpu_torch/ops/csrc/mha.cu",
    "mha_qkv_bwd": "anomalyclip_tpu_torch/ops/csrc/mha_bwd.cu",
    "mha_bld_bwd": "anomalyclip_tpu_torch/ops/csrc/mha_bwd.cu",
}
REPLACES = {
    "fused_mha_qkv": "anomalyclip_tpu/ops/pallas/attention.py:423",
    "fused_mha_bld": "anomalyclip_tpu/ops/pallas/attention.py:88",
    "mha_qkv_bwd": "anomalyclip_tpu/ops/pallas/attention.py:291",
    "mha_bld_bwd": "anomalyclip_tpu/ops/pallas/attention.py:273",
}
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
FP32_SLICE_TOL = 1e-4
# the plain attention rounds as the kernel does, so the two bf16 passes differ
# only by summation order (about 3.4e-2 after the twelve bf16 layers); bf16
# against fp32 differs by about 6.0e-2, which this limit rejects
BF16_SLICE_TOL = 5e-2

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
    from anomalyclip_tpu_torch.ops import build

    start = time.perf_counter()
    build.load_library()
    print(f"[build] {build.library_path().name}: {time.perf_counter() - start:.2f} s")
    torch.cuda.synchronize()


def median_ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels() -> dict:
    """Each kernel against its plain version -> {name: fp32 max error, times}."""
    from anomalyclip_tpu_torch.ops.attention import (
        fused_mha_bld,
        fused_mha_qkv,
        mha_bld_reference,
        mha_qkv_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for b, l, d, h, causal in ((256, 197, 768, 12, False), (14, 77, 512, 8, True)):
        qkv = torch.randn(b, l, 3 * d, device="cuda", generator=gen)
        cases.append((
            "fused_mha_qkv", (b, l, 3 * d), h, causal, qkv,
            lambda t, h=h, c=causal: fused_mha_qkv(t, h, c),
            lambda t, h=h, c=causal: mha_qkv_reference(t, h, c),
        ))
    for b, l, d, h in ((64, 32, 256, 8), (128, 16, 256, 8)):
        qkv = torch.randn(b, l, 3 * d, device="cuda", generator=gen)  # q | k v
        cases.append((
            "fused_mha_bld", (b, l, d), h, False, qkv,
            lambda t, h=h, d=d: fused_mha_bld(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], h),
            lambda t, h=h, d=d: mha_bld_reference(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], h),
        ))

    report = {}
    for name, shape, heads, causal, x32, kernel, plain in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got, want = kernel(x), plain(x)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
            ms, plain_ms = median_ms(lambda: kernel(x)), median_ms(lambda: plain(x))
            print(f"[kernels] {name} {shape} heads={heads} causal={causal} "
                  f"{str(dtype).split('.')[-1]}: max|err| {err:.3e} (tol {tol:g}), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            entry = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
            if dtype == torch.float32:
                # the path runs fp32: one call at each of its shapes, summed
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["ms"] += ms
                entry["plain_ms"] += plain_ms
    torch.cuda.synchronize()
    return report


def phase_bwd_kernels() -> dict:
    """K3 and K4 against their plain backwards -> {name: fp32 max error, times}."""
    from anomalyclip_tpu_torch.ops.attention import (
        mha_bld_bwd_kernel,
        mha_bld_bwd_reference,
        mha_qkv_bwd_kernel,
        mha_qkv_bwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = []
    # the text tower's backward: (14, 77, 1536), 8 heads, causal
    qkv = torch.randn(14, 77, 3 * 512, device="cuda", generator=gen)
    g = torch.randn(14, 77, 512, device="cuda", generator=gen)
    cases.append((
        "mha_qkv_bwd", (14, 77, 3 * 512), True, (qkv, g),
        lambda t, g: (mha_qkv_bwd_kernel(t, g, 8, True),),
        lambda t, g: (mha_qkv_bwd_reference(t, g, 8, True),),
    ))
    # the temporal model's backward along segments and along frames, k and v
    # the two halves of one kv
    for b, l in ((1024, 32), (2048, 16)):
        qkv = torch.randn(b, l, 3 * 256, device="cuda", generator=gen)  # q | k v
        g = torch.randn(b, l, 256, device="cuda", generator=gen)
        cases.append((
            "mha_bld_bwd", (b, l, 256), False, (qkv, g),
            lambda t, g: mha_bld_bwd_kernel(t[..., :256], t[..., 256:512], t[..., 512:], g, 8, False),
            lambda t, g: mha_bld_bwd_reference(t[..., :256], t[..., 256:512], t[..., 512:], g, 8),
        ))

    report = {}
    for name, shape, causal, inputs32, kernel, plain in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, g = (t.to(dtype) for t in inputs32)
            got, want = kernel(x, g), plain(x, g)
            torch.cuda.synchronize()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            scale = max(b.float().abs().max().item() for b in want)
            tol = TOLERANCE[dtype] * scale
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
            ms, plain_ms = median_ms(lambda: kernel(x, g)), median_ms(lambda: plain(x, g))
            print(f"[bwd kernels] {name} {shape} heads=8 causal={causal} "
                  f"{str(dtype).split('.')[-1]}: max|err| {err:.3e} (tol {tol:.3e} = "
                  f"{TOLERANCE[dtype]:g} x max|ref| {scale:.3e}), "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            entry = report.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0})
            if dtype == torch.float32:
                # the step runs fp32: one call at each of its shapes, summed
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["ms"] += ms
                entry["plain_ms"] += plain_ms
    torch.cuda.synchronize()
    return report


def build_ucf_model(device: str, compute_dtype: str = "float32", load_from_features: bool = False):
    """UCF-Crime ViT-B/16 at full width from the port's seeded init."""
    from anomalyclip_tpu_torch.convert import tree_to
    from anomalyclip_tpu_torch.models.anomaly_clip import AnomalyCLIP, AnomalyCLIPConfig
    from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, init_clip_params
    from anomalyclip_tpu_torch.models.selector import BNState

    gen = torch.Generator().manual_seed(SEED)
    clip_cfg = CLIPConfig.vit_b16()
    cfg = AnomalyCLIPConfig(
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


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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


def phase_slice() -> dict:
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
    predictor = Predictor(model, frozen, trainable, bn_state, ncentroid, device="cuda")
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
    expected = {
        "fused_mha_qkv": clip_cfg.transformer_layers + clip_cfg.vision_layers * chunks,
        "fused_mha_bld": 2 * cfg.depth * len(VIDEO_FRAMES),
        "mha_qkv_bwd": 0,  # scoring runs no backward
        "mha_bld_bwd": 0,
    }
    print(f"[slice] launches {launches}, expected {expected} ({chunks} encode calls)")
    require(launches == expected, f"launches {launches}, expected {expected}")

    with attention_impl("reference"):
        ref_predictor = Predictor(model, frozen, trainable, bn_state, ncentroid, device="cuda")
        ref_vs, _ = ref_predictor.score_frames(videos[CHECK_VIDEO])
    torch.cuda.synchronize()
    err = assert_videos_close(outputs[CHECK_VIDEO], ref_vs, FP32_SLICE_TOL, "fp32 kernel vs plain")
    print(f"[slice] fp32 {CHECK_VIDEO} frames, kernels vs plain attention: max|diff| {err:.3e} "
          f"(limit {FP32_SLICE_TOL:g})")

    cfg16 = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    model16 = AnomalyCLIP(cfg16, model.clip_cfg, model.classnames, model.prompt_spec)
    pred16 = Predictor(model16, frozen, trainable, bn_state, ncentroid, device="cuda")
    start = time.perf_counter()
    vs16, res16 = pred16.score_frames(videos[CHECK_VIDEO])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    check_video(vs16, res16, CHECK_VIDEO, n_abn)
    print(f"[slice] bf16 video {CHECK_VIDEO} frames: {seconds:.3f} s, "
          f"{CHECK_VIDEO / seconds:.1f} frames/s")
    with attention_impl("reference"):
        ref16 = Predictor(model16, frozen, trainable, bn_state, ncentroid, device="cuda")
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
    return launches


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

    # the main path: counters from zero, three steps, counters read
    reset_launch_counts()
    run = run_training(model, frozen, trainable, bn_state, batches, ncentroid)
    launches = dict(launch_counts)
    text_layers, depth = model.clip_cfg.transformer_layers, model.cfg.depth
    per_step = {"fused_mha_qkv": text_layers, "mha_qkv_bwd": text_layers,
                "fused_mha_bld": 2 * depth, "mha_bld_bwd": 2 * depth}
    expected = {k: TRAIN_STEPS * per_step[k] for k in launch_counts}
    print(f"[train] launches {launches}, expected {expected}")
    require(launches == expected, f"launches {launches}, expected {expected}")

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
    worst, differing = 0.0, 0
    for got, want in zip(run.grads, ref.grads):
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
          f"differ at all); losses max rel diff "
          f"{max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)):.3e} "
          f"(limit {TRAIN_LOSS_RTOL:g})")
    torch.cuda.synchronize()
    return launches


def kernel_class(name: str) -> str:
    low = name.lower()
    if "mha_fwd_kernel" in low:
        return "attention (mha.cu)"
    if "mha_bwd_kernel" in low:
        return "attention backward (mha_bwd.cu)"
    if low.startswith(("memcpy", "memset")):
        return "copies"
    # cuDNN's convolutions, with the FFT passes, the complex GEMMs they call
    # and their layout conversions
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv", "cudnn", "fft", "cf32")):
        return "convolutions (cuDNN)"
    if "gemm" in low or "nvjet" in low or "gemv" in low:
        return "GEMM"
    return "elementwise and reductions"


def profile_call(fn, top: int = 15) -> dict:
    """Three warm calls of fn on the host clock, then one under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
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
        predictor = Predictor(m, frozen, trainable, bn_state, ncentroid, device="cuda")
        results[dtype] = profile_call(lambda: predictor.score_frames(frames))
        print_profile(f"{dtype} {CHECK_VIDEO} frames", results[dtype])

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
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"[profile] wrote {out}")
    torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", type=Path, metavar="OUT.json",
                        help="also profile one warm 700-frame call per dtype and one "
                             "warm training step")
    args = parser.parse_args()
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    report.update(phase_bwd_kernels())
    slice_launches = phase_slice()
    train_launches = phase_train()
    if args.profile:
        phase_profile(args.profile, smi)
    # each path ran its kernels: the forwards on both, the backwards on training
    require(all(slice_launches[k] > 0 for k in ("fused_mha_qkv", "fused_mha_bld")),
            f"a kernel of the scoring path was never launched: {slice_launches}")
    require(all(n > 0 for n in train_launches.values()),
            f"a kernel of the training path was never launched: {train_launches}")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE[name],
            "replaces": REPLACES[name],
            "launches": slice_launches[name] + train_launches[name],
            "max_abs_err": report[name]["max_abs_err"],
            "ms": report[name]["ms"],
            "plain_ms": report[name]["plain_ms"],
        }
        for name in ("fused_mha_qkv", "fused_mha_bld", "mha_qkv_bwd", "mha_bld_bwd")
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
