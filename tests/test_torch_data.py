"""The port's data layer (anomalyclip_tpu_torch/data) against the JAX package's
(anomalyclip_tpu/data), on the CPU, to the bit: the same seed and the same
files give the same records, sampling draws, transforms, synthetic files,
source items, dataset items, loader batches (two epochs, two shards) and
datamodule loaders. Also the loader's threads end when a loader is closed or
an iterator is dropped half-way, and the synthetic generator's stamp and
refusal hold. Every loader a test opens is closed."""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from anomalyclip_tpu.data import datamodule as jdm
from anomalyclip_tpu.data import dataset as jds
from anomalyclip_tpu.data import loader as jld
from anomalyclip_tpu.data import records as jrec
from anomalyclip_tpu.data import sampling as jsam
from anomalyclip_tpu.data import sources as jsrc
from anomalyclip_tpu.data import synthetic as jsyn
from anomalyclip_tpu.data import transforms as jtr
from anomalyclip_tpu_torch.data import datamodule as tdm
from anomalyclip_tpu_torch.data import dataset as tds
from anomalyclip_tpu_torch.data import loader as tld
from anomalyclip_tpu_torch.data import records as trec
from anomalyclip_tpu_torch.data import sampling as tsam
from anomalyclip_tpu_torch.data import sources as tsrc
from anomalyclip_tpu_torch.data import synthetic as tsyn
from anomalyclip_tpu_torch.data import transforms as ttr

N, L, STRIDE = 4, 3, 1
NUM_CLASSES, NORMAL_ID = 6, 3
# a small corpus with frames: more abnormal than normal videos, so the shorter
# stream cycles within an epoch
CORPUS = dict(num_normal=3, num_abnormal=5, num_test=4, num_classes=NUM_CLASSES,
              normal_id=NORMAL_ID, feature_dim=16, min_frames=20, max_frames=34, seed=7,
              make_frames=True, frame_size=32)


def same(got, want, where: str = "") -> None:
    """Equal to the bit, recursively: arrays by dtype, shape and bytes (nan
    equal to nan), named tuples and dataclasses by field."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype,
                                                                     got.shape, want.shape)
        assert got.tobytes() == want.tobytes(), where
    elif dataclasses.is_dataclass(want):
        same(dataclasses.astuple(got), dataclasses.astuple(want), where)
    elif isinstance(want, tuple) and hasattr(want, "_fields"):
        assert got._fields == want._fields, where
        for name in want._fields:
            same(getattr(got, name), getattr(want, name), f"{where}.{name}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's synthetic corpus with frames -> (frames_root, annotations_root)."""
    root = tmp_path_factory.mktemp("torch_data")
    tsyn.generate_synthetic_dataset(root / "features", root / "annotations", **CORPUS)
    return root / "features", root / "annotations"


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def test_records_parse_as_the_original(tmp_path):
    spatial = tmp_path / "spatial"
    spatial.mkdir()
    (spatial / "Arson011.txt").write_text(
        "0 10 10 20 20 4 0 0 0 Arson\n1 10 10 20 20 5 1 0 0 Arson\n"
        "2 10 10 20 20 9 0 0 0 Arson\nshort row\n3 10 10 20 20 40 0 0 0 Arson\n"
    )
    annotation = tmp_path / "train.txt"
    annotation.write_text(
        "Arson/Arson011_x264 4 120 1\n\nNormal/Normal_001_x264 0 99 7 3\nplain 2 40 0\n"
    )
    temporal = tmp_path / "temporal.txt"
    temporal.write_text("Arson011_x264.mp4 Arson 10 20 50 -1\n\nNormal_001_x264.mp4 Normal -1 -1\n")
    for spatial_dir in (None, str(spatial)):
        got = trec.parse_annotation_file(annotation, "/data/root", spatial_dir)
        want = jrec.parse_annotation_file(annotation, "/data/root", spatial_dir)
        same(got, want)
        for g, w in zip(got, want):
            assert (g.num_frames, g.frames_dir, g.feature_path, g.stem) == (
                w.num_frames, w.frames_dir, w.feature_path, w.stem)
    assert got[0].spatial_annotation == spatial / "Arson011.txt"
    annotations = trec.parse_temporal_annotations(temporal)
    same(annotations, jrec.parse_temporal_annotations(temporal))
    same(trec.parse_temporal_annotations(None), jrec.parse_temporal_annotations(None))
    same(trec.parse_temporal_annotations(tmp_path / "missing.txt"), {})
    for record in got:
        for frames in (30, 117, 200):
            same(trec.frame_labels_for(record, annotations, frames, 7),
                 jrec.frame_labels_for(record, annotations, frames, 7))
    for lo, hi in ((0, 100), (5, 9), (10, 3)):
        same(trec.parse_spatial_annotation(spatial / "Arson011.txt", lo, hi),
             jrec.parse_spatial_annotation(spatial / "Arson011.txt", lo, hi))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
def test_sampling_draws_as_the_original(stride):
    """The same draws in the same order: the generators' states agree after
    every call, so the items after them agree too."""
    ours, theirs = np.random.default_rng(11), np.random.default_rng(11)
    for t in (1, 5, 15, 31, 32, 33, 100, 513, 2000):
        for n, l in ((4, 3), (32, 16), (3, 1)):
            same(tsam.train_start_indices(t, n, l, stride, ours),
                 jsam.train_start_indices(t, n, l, stride, theirs), f"train {t} {n} {l}")
            same(ours.bit_generator.state, theirs.bit_generator.state)
            got, want = tsam.test_start_indices(t, n, l, stride), jsam.test_start_indices(t, n, l, stride)
            same(got, want, f"test {t} {n} {l}")
            same(tsam.gather_frame_indices(got[0], l, stride, t),
                 jsam.gather_frame_indices(want[0], l, stride, t))
    same(tsam.round_up_to_multiple(45, 16), jsam.round_up_to_multiple(45, 16))


@pytest.mark.parametrize("t", [1, 3, 32, 33, 100, 777])
def test_process_feat_as_the_original(t):
    feat = np.random.default_rng(t).standard_normal((t, 8)).astype(np.float32)
    for length in (1, 7, 32, 64):
        same(tsam.process_feat(feat, length), jsam.process_feat(feat, length), f"{t} -> {length}")


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _clip(seed: int = 0, shape=(3, 40, 52, 3)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# name -> (factory given a transforms module, input dtype)
TRANSFORMS = {
    "scale_int": lambda m: m.GroupScale(32),
    "scale_int_tall": lambda m: (m.GroupScale(30), (3, 52, 40, 3)),
    "scale_hw": lambda m: m.GroupScale((20, 30)),
    "resize": lambda m: m.GroupResize(32),
    "center_crop": lambda m: m.GroupCenterCrop(23),
    "random_crop": lambda m: m.GroupRandomCrop(24),
    "flip": lambda m: m.GroupRandomHorizontalFlip(),
    "oversample": lambda m: m.GroupOverSample(24, scale_size=32),
    "fc_sample": lambda m: m.GroupFCSample(24),
    "ten_crop": lambda m: m.GroupTenCrop(23),
    "multiscale_fix": lambda m: m.GroupMultiScaleCrop(24),
    "multiscale_free": lambda m: m.GroupMultiScaleCrop((24, 20), fix_crop=False),
    "multiscale_five": lambda m: m.GroupMultiScaleCrop(24, more_fix_crop=False, max_distort=2),
    "sized_crop": lambda m: m.GroupRandomSizedCrop(24),
    "sized_crop_fallback": lambda m: (m.GroupRandomSizedCrop(24), (3, 40, 4, 3)),
    "color_jitter": lambda m: m.GroupRandomColorJitter(p=1.0),
    "color_jitter_hue_only": lambda m: m.GroupRandomColorJitter(1.0, 0, 0, 0, 0.5),
    "grayscale": lambda m: m.GroupRandomGrayscale(p=1.0),
    "blur": lambda m: m.GroupGaussianBlur(p=1.0),
    "solarize": lambda m: m.GroupSolarization(p=1.0),
    "to_float": lambda m: m.GroupToFloat(),
    "to_float_nodiv": lambda m: m.GroupToFloat(div=False),
    "normalize": lambda m: m.Compose([m.GroupToFloat(), m.GroupNormalize()]),
    "loop_pad": lambda m: m.LoopPad(8),
    "identity": lambda m: m.IdentityTransform(),
    "augment_1": lambda m: m.get_augmentations(24, 1),
    "augment_10": lambda m: m.get_augmentations(24, 10),
    "augment_1_u8": lambda m: m.get_augmentations(24, 1, normalize=False),
    "augment_10_u8": lambda m: m.get_augmentations(24, 10, normalize=False),
    "train_chain": lambda m: m.Compose([
        m.GroupMultiScaleCrop(28), m.GroupRandomHorizontalFlip(), m.GroupRandomColorJitter(0.8),
        m.GroupRandomGrayscale(0.5), m.GroupGaussianBlur(0.5), m.GroupSolarization(0.5),
        m.GroupToFloat(), m.GroupNormalize()]),
}


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_gives_the_originals_bits(name):
    made = {m: TRANSFORMS[name](m) for m in (ttr, jtr)}
    shape = (3, 40, 52, 3)
    if isinstance(made[ttr], tuple):
        (made[ttr], shape), (made[jtr], _) = made[ttr], made[jtr]
    for seed in range(3):
        clip = _clip(seed, shape)
        outs = []
        for m in (ttr, jtr):
            rng = np.random.default_rng(seed)
            fn = made[m]
            wants_rng = isinstance(fn, m.Compose) or m._needs_rng(fn)
            outs.append((fn(clip.copy(), rng) if wants_rng else fn(clip.copy()), rng.bit_generator.state))
        same(outs[0], outs[1], f"{name} seed {seed}")


@pytest.mark.parametrize("fn", ["adjust_brightness", "adjust_contrast", "adjust_saturation",
                                "adjust_hue"])
def test_photometric_function_as_the_original(fn):
    clip = _clip(3).astype(np.float32)
    factors = (-0.5, -0.1, 0.0, 0.25, 0.5) if fn == "adjust_hue" else (0.0, 0.6, 1.0, 1.7)
    for factor in factors:
        same(getattr(ttr, fn)(clip, factor), getattr(jtr, fn)(clip, factor), f"{fn}({factor})")


def test_geometry_helpers_as_the_original():
    for sigma in (0.1, 0.7, 2.0):
        same(ttr.gaussian_blur_clip(_clip(4), sigma), jtr.gaussian_blur_clip(_clip(4), sigma))
    for h in range(20, 60, 3):
        for w in range(20, 60, 7):
            for size in (16, 24):
                same(ttr._short_side_size(h, w, size), jtr._short_side_size(h, w, size))
                same(ttr.fill_fix_offset(True, w, h, size, size),
                     jtr.fill_fix_offset(True, w, h, size, size))
                same(ttr.fill_fc_fix_offset(w, h, size, size), jtr.fill_fc_fix_offset(w, h, size, size))
    for margin in range(0, 40):
        same(ttr._center_offset(margin), jtr._center_offset(margin))
    same(ttr.CLIP_MEAN, jtr.CLIP_MEAN)
    same(ttr.CLIP_STD, jtr.CLIP_STD)
    for interpolation in ("bicubic", "bilinear", "nearest"):
        same(ttr.resize_clip(_clip(5), (17, 29), interpolation),
             jtr.resize_clip(_clip(5), (17, 29), interpolation))


# ---------------------------------------------------------------------------
# the synthetic generator
# ---------------------------------------------------------------------------


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("make_frames", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_files_equal_the_originals(tmp_path, seed, make_frames):
    params = dict(CORPUS, seed=seed, make_frames=make_frames, num_test=3)
    for name, gen in (("port", tsyn), ("jax", jsyn)):
        gen.generate_synthetic_dataset(tmp_path / name / "f", tmp_path / name / "a", **params)
    for sub in ("f", "a"):
        got, want = _files(tmp_path / "port" / sub), _files(tmp_path / "jax" / sub)
        assert sorted(got) == sorted(want)
        assert got == want, sub  # .npy, annotations, the stamp and the JPEGs, byte for byte
    jpegs = sorted((tmp_path / "port" / "f").rglob("*.jpg"))
    assert bool(jpegs) == make_frames
    from PIL import Image

    for path in jpegs[:20]:
        twin = tmp_path / "jax" / path.relative_to(tmp_path / "port")
        with Image.open(path) as a, Image.open(twin) as b:
            same(np.asarray(a), np.asarray(b), str(path))


def test_synthetic_stamp_skips_regenerates_and_refuses(tmp_path):
    frames, annos = tmp_path / "s" / "f", tmp_path / "s" / "a"
    params = dict(CORPUS, make_frames=False)
    tsyn.generate_synthetic_dataset(frames, annos, **params)
    npy = frames / "normal_000.npy"
    before = npy.stat().st_mtime_ns
    tsyn.generate_synthetic_dataset(frames, annos, **params)  # same parameters: untouched
    assert npy.stat().st_mtime_ns == before
    changed = dict(params, max_frames=40)
    tsyn.generate_synthetic_dataset(frames, annos, **changed)  # owned: rewritten
    jsyn.generate_synthetic_dataset(tmp_path / "j" / "f", tmp_path / "j" / "a", **changed)
    assert _files(frames) == _files(tmp_path / "j" / "f")
    assert _files(annos) == _files(tmp_path / "j" / "a")
    assert not (tmp_path / "s" / ".synthetic_lock").exists()
    foreign = tmp_path / "foreign"
    (foreign / "f").mkdir(parents=True)
    (foreign / "f" / "keep.txt").write_text("not generated")
    with pytest.raises(RuntimeError, match="refusing to generate synthetic data"):
        tsyn.generate_synthetic_dataset(foreign / "f", foreign / "a", **params)
    assert (foreign / "f" / "keep.txt").read_text() == "not generated"
    assert not (foreign / ".synthetic_lock").exists()


def test_synthetic_lock_serialises_writers(tmp_path):
    """Two threads generating into one root: one writes, the other waits for the
    lock, finds the stamp and returns; the files are the single writer's."""
    frames, annos = tmp_path / "f", tmp_path / "a"
    params = dict(CORPUS, make_frames=False)
    errors = []

    def run():
        try:
            tsyn.generate_synthetic_dataset(frames, annos, **params)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == []
    jsyn.generate_synthetic_dataset(tmp_path / "j" / "f", tmp_path / "j" / "a", **params)
    assert _files(frames) == _files(tmp_path / "j" / "f")


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def test_feature_source_as_the_original(corpus, tmp_path):
    frames, annos = corpus
    records = trec.parse_annotation_file(annos / "Anomaly_Test.txt", str(frames))
    # a ten-crop feature file: (T, ncrops, D)
    np.save(tmp_path / "tencrop.npy", np.random.default_rng(2).standard_normal((24, 10, 16)))
    tencrop = [trec.VideoRecord("tencrop", 0, 23, NORMAL_ID, str(tmp_path))]
    idx = np.array([0, 5, 3, 3, 19, 1])
    for ncrops, videos in ((1, records), (10, tencrop)):
        ours, theirs = tsrc.FeatureSource(ncrops), jsrc.FeatureSource(ncrops)
        for record in videos:
            got, want = ours.load_video(record), theirs.load_video(record)
            same(got, want)
            assert ours.num_frames(got) == theirs.num_frames(want)
            same(ours.gather(got, idx % len(got)), theirs.gather(want, idx % len(want)))


@pytest.mark.parametrize("input_size", [24, 224])
@pytest.mark.parametrize("size", [(32, 32), (45, 31), (30, 61)])
def test_frame_preprocessing_as_the_original(tmp_path, size, input_size):
    from PIL import Image

    pixels = np.random.default_rng(size[0]).integers(0, 256, size + (3,), dtype=np.uint8)
    path = tmp_path / "frame.jpg"
    Image.fromarray(pixels).save(path, quality=90)
    with Image.open(path) as img:
        same(tsrc.spatial_frame(img, input_size), jsrc.spatial_frame(img, input_size))
        same(tsrc.preprocess_frame(img, input_size), jsrc.preprocess_frame(img, input_size))
    same(tsrc.spatial_frame_cv2(str(path), input_size), jsrc.spatial_frame_cv2(str(path), input_size))
    same(tsrc.preprocess_frame_cv2(str(path), input_size),
         jsrc.preprocess_frame_cv2(str(path), input_size))
    same(tsrc.normalize_frames(pixels), jsrc.normalize_frames(pixels))
    with pytest.raises(FileNotFoundError):
        tsrc.spatial_frame_cv2(str(tmp_path / "missing.jpg"))


@pytest.mark.parametrize("ncrops,fast_decode", [(1, False), (1, True), (10, False), (10, True)])
def test_frame_source_as_the_original(corpus, ncrops, fast_decode):
    frames, annos = corpus
    records = trec.parse_annotation_file(annos / "Anomaly_Train_Abnormal.txt", str(frames))
    kw = dict(input_size=24, ncrops=ncrops, fast_decode=fast_decode)
    ours, theirs = tsrc.FrameSource(**kw), jsrc.FrameSource(**kw)
    idx = np.array([0, 7, 2, 2, 19])
    for record in records[:2]:
        assert ours.num_frames(ours.load_video(record)) == theirs.num_frames(record)
        got = ours.gather(ours.load_video(record), idx)
        same(got, theirs.gather(record, idx))
        assert got.shape == (ncrops, len(idx), 24, 24, 3) and got.dtype == np.uint8
        same(ours.gather(record, idx, pool=tds._shared_decode_pool()), got)
    with pytest.raises(ValueError, match="ncrops in"):
        tsrc.FrameSource(ncrops=5)
    for tmpl in ("{:06d}.jpg", "{:05d}.jpg"):
        assert tsrc.count_frames(frames / records[0].rel_path, tmpl) == jsrc.count_frames(
            frames / records[0].rel_path, tmpl)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _datasets(corpus, annotation: str, features: bool, test_mode: bool):
    frames, annos = corpus
    out = []
    for ds, src in ((tds, tsrc), (jds, jsrc)):
        source = src.FeatureSource(1) if features else src.FrameSource(input_size=24)
        out.append(ds.VideoDataset(
            annotation_file=str(annos / annotation), root=str(frames), normal_id=NORMAL_ID,
            sampling=ds.SamplingConfig(num_segments=N, frames_per_segment=L, stride=STRIDE),
            source=source, test_mode=test_mode,
            temporal_annotation_file=str(annos / "Temporal_Anomaly_Annotation_for_Testing_Videos.txt"),
        ))
    return out


@pytest.mark.parametrize("features", [True, False], ids=["features", "frames"])
def test_dataset_items_as_the_originals(corpus, features):
    ours, theirs = _datasets(corpus, "Anomaly_Train_Abnormal.txt", features, False)
    assert len(ours) == len(theirs) == CORPUS["num_abnormal"]
    for i in range(len(ours)):
        rngs = np.random.default_rng(i), np.random.default_rng(i)
        same(ours.train_item(i, rngs[0]), theirs.train_item(i, rngs[1]), f"train {i}")
    ours, theirs = _datasets(corpus, "Anomaly_Test.txt", features, True)
    for i in range(len(ours)):
        got = ours.test_item(i)
        assert type(got) is tds.TestItem
        same(got, theirs.test_item(i), f"test {i}")
    assert any((ours.test_item(i).frame_labels != NORMAL_ID).any() for i in range(len(ours)))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def _train_loader(mod_ds, mod_src, mod_ld, corpus, shard, num_workers=2, prefetch=2):
    frames, annos = corpus

    def make(name):
        return mod_ds.VideoDataset(
            annotation_file=str(annos / name), root=str(frames), normal_id=NORMAL_ID,
            sampling=mod_ds.SamplingConfig(num_segments=N, frames_per_segment=L, stride=STRIDE),
            source=mod_src.FeatureSource(1),
        )

    return mod_ld.DualStreamTrainLoader(
        normal=make("Anomaly_Train_Normal.txt"), abnormal=make("Anomaly_Train_Abnormal.txt"),
        batch_size=4, seed=7, num_workers=num_workers, prefetch=prefetch,
        process_index=shard[0], process_count=shard[1],
    )


def test_train_batches_as_the_originals_over_two_epochs_and_shards(corpus):
    """Each shard's batches equal the original's to the bit, and the port's
    shards are the rows of its single-process batch."""
    loaders = {
        (pkg, shard): _train_loader(*mods, corpus, shard)
        for pkg, mods in (("port", (tds, tsrc, tld)), ("jax", (jds, jsrc, jld)))
        for shard in ((0, 1), (0, 2), (1, 2))
    }
    try:
        assert len(loaders["port", (0, 1)]) == len(loaders["jax", (0, 1)]) == 2  # 5 // 2 cycles 3 // 2
        for epoch in (0, 1):
            batches = {}
            for key, loader in loaders.items():
                loader.set_epoch(epoch)
                batches[key] = list(loader)
            for shard in ((0, 1), (0, 2), (1, 2)):
                same(batches["port", shard], batches["jax", shard], f"epoch {epoch} shard {shard}")
            for whole, b0, b1 in zip(batches["port", (0, 1)], batches["port", (0, 2)],
                                     batches["port", (1, 2)]):
                for field in tld.TrainBatch._fields:
                    same(np.concatenate([getattr(b0, field), getattr(b1, field)]), getattr(whole, field))
                assert b0.abnormal_features.shape == (1, 1, N * L, CORPUS["feature_dim"])
        assert not np.array_equal(batches["port", (0, 1)][0].abnormal_features,
                                  _first_batch(loaders["port", (0, 1)], 0).abnormal_features)
    finally:
        for loader in loaders.values():
            loader.close()
    with pytest.raises(ValueError):
        _train_loader(tds, tsrc, tld, corpus, (0, 3))
    with pytest.raises(ValueError):
        _train_loader(tds, tsrc, tld, corpus, (2, 2))


def _first_batch(loader, epoch):
    loader.set_epoch(epoch)
    return next(iter(loader))


def _prefetch_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "anomalyclip-prefetch" and t.is_alive()]


def _wait_for_no_prefetch_threads(timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while _prefetch_threads() and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert _prefetch_threads() == []


def test_loader_threads_end_on_close_and_on_a_dropped_iterator(corpus):
    """A half-read epoch (depth 1, so the worker blocks on a full queue) ends its
    prefetch thread once the iterator is dropped; close() ends the pool's."""
    _wait_for_no_prefetch_threads()
    loader = _train_loader(tds, tsrc, tld, corpus, (0, 1), num_workers=3, prefetch=1)
    try:
        it = iter(loader)
        next(it)
        time.sleep(0.2)  # the worker fills the queue and waits on it
        assert len(_prefetch_threads()) == 1
        del it
        _wait_for_no_prefetch_threads()
        assert len(list(loader)) == len(loader)
    finally:
        loader.close()
    for t in list(loader._pool._threads):
        t.join(timeout=10)
        assert not t.is_alive()
    with pytest.raises(RuntimeError):
        loader._pool.submit(int)


def test_prefetch_surfaces_the_workers_error():
    def boom():
        yield 1
        raise KeyError("in the worker")

    it = tld._prefetched(boom(), 2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="in the worker"):
        next(it)
    _wait_for_no_prefetch_threads()
    assert list(tld._prefetched(iter([1, 2, 3]), 0)) == [1, 2, 3]


def test_test_loader_items_shards_and_limits_as_the_originals(corpus):
    ours, theirs = _datasets(corpus, "Anomaly_Test.txt", True, True)
    for limit in (None, 3):
        for shard in ((0, 1), (0, 2), (1, 2)):
            a = tld.SequentialTestLoader(ours, limit=limit, shard=shard)
            b = jld.SequentialTestLoader(theirs, limit=limit, shard=shard)
            assert list(a.global_indices()) == list(b.global_indices())
            assert len(a) == len(b)
            same(list(a), list(b), f"limit {limit} shard {shard}")
    with pytest.raises(ValueError):
        tld.SequentialTestLoader(ours, shard=(2, 2))
    for total in (0, 1, 7, 10):
        for limit in (None, 0.0, 0.05, 0.5, 1.0, 1, 3, 20, 2.0):
            assert tld.limit_count(total, limit) == jld.limit_count(total, limit), (total, limit)


# ---------------------------------------------------------------------------
# the datamodule
# ---------------------------------------------------------------------------


def _data_config(corpus, **overrides) -> dict:
    frames, annos = corpus
    cfg = dict(
        annotation_file_normal=str(annos / "Anomaly_Train_Normal.txt"),
        annotation_file_anomaly=str(annos / "Anomaly_Train_Abnormal.txt"),
        annotation_file_test=str(annos / "Anomaly_Test.txt"),
        annotation_file_temporal_test=str(annos / "Temporal_Anomaly_Annotation_for_Testing_Videos.txt"),
        frames_root=str(frames), labels_file="unused.csv", normal_id=NORMAL_ID,
        num_classes=NUM_CLASSES, num_segments=N, seg_length=L, batch_size=4, num_workers=2,
        input_size=24, not_a_field="ignored",
    )
    cfg.update(overrides)
    return cfg


@pytest.mark.parametrize("features", [True, False], ids=["features", "frames"])
def test_datamodule_loaders_as_the_originals(corpus, features):
    raw = _data_config(corpus, load_from_features=features)
    cfg = tdm.DataConfig.from_dict(raw)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jdm.DataConfig.from_dict(raw))
    ours, theirs = tdm.AnomalyCLIPDataModule(cfg, seed=3), jdm.AnomalyCLIPDataModule(
        jdm.DataConfig.from_dict(raw), seed=3)
    assert ours.num_classes == NUM_CLASSES
    ours.setup()
    ours.setup()  # once only
    for name in ("val_dataloader", "test_dataloader", "train_dataloader_test_mode"):
        for kw in ({}, {"limit": 2, "shard": (1, 2)}):
            a, b = getattr(ours, name)(**kw), getattr(theirs, name)(**kw)
            assert type(a) is tld.SequentialTestLoader
            same(list(a), list(b), f"{name} {kw}")
    for shard in ((0, 1), (1, 2)):
        a, b = ours.train_dataloader(shard), theirs.train_dataloader(shard)
        try:
            assert type(a) is tld.DualStreamTrainLoader
            for epoch in (0, 1):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                same(list(a), list(b), f"train shard {shard} epoch {epoch}")
        finally:
            a.close()
            b.close()


def test_package_exports_as_the_originals():
    import anomalyclip_tpu.data as jdata
    import anomalyclip_tpu_torch.data as tdata

    assert tdata.__all__ == jdata.__all__
    for name in tdata.__all__:
        assert getattr(tdata, name).__module__.startswith("anomalyclip_tpu_torch.data.")
    assert tds.TestItem._fields == jds.TestItem._fields
    assert tds.TestItem._field_defaults == jds.TestItem._field_defaults
    assert tld.TrainBatch._fields == jld.TrainBatch._fields
    assert [f.name for f in dataclasses.fields(tdm.DataConfig)] == [
        f.name for f in dataclasses.fields(jdm.DataConfig)]
    assert dataclasses.astuple(tds.SamplingConfig()) == dataclasses.astuple(jds.SamplingConfig())
