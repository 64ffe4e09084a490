"""The port's feature extractor against the JAX package's, on the CPU: ports of
the three tests of tests/test_extract_features.py.

Both extractors read one CLIP file written here (a tiny ViT of 32-pixel frames
in OpenAI's key layout) and the same JPEG frames; the ``.npy`` files they write
agree within 1e-4 (fp32 features, tests/test_golden.py), in the (T, D) and
(T, ncrops, D) layouts ``FeatureSource`` reads. ``FeatureWriter`` on uint8
arrays (no decoder) equals the tower's encode of the same frames.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from anomalyclip_tpu import extract_features as jextract
from anomalyclip_tpu_torch import extract_features
from anomalyclip_tpu_torch.data.records import VideoRecord
from anomalyclip_tpu_torch.data.sources import FeatureSource, FrameSource
from anomalyclip_tpu_torch.models.clip.convert import load_torch_clip_checkpoint, state_dict_from_params
from anomalyclip_tpu_torch.models.clip.model import CLIPConfig, encode_image, init_clip_params

GOLDEN = 1e-4
# one head of width 64: the heads a CLIP file's shapes give (config_from_state_dict)
CLIP = CLIPConfig(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=64, vision_patch_size=16,
                  transformer_width=64, transformer_heads=1, transformer_layers=2)


@pytest.fixture()
def frames_corpus(tmp_path):
    """Two videos of 32x32 frames, an annotation file and a CLIP file."""
    rng = np.random.default_rng(0)
    froot = tmp_path / "frames"
    lengths = {"vid_a": 7, "vid_b": 5}
    for name, n in lengths.items():
        vdir = froot / name
        vdir.mkdir(parents=True)
        for i in range(1, n + 1):
            Image.fromarray(rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)).save(
                vdir / f"{i:06d}.jpg", quality=95)
    ann = tmp_path / "ann.txt"
    ann.write_text("vid_a 1 7 0\nvid_b 1 5 1\n")
    clip = tmp_path / "clip.pt"
    torch.save(state_dict_from_params(init_clip_params(torch.Generator().manual_seed(3), CLIP)), clip)
    return froot, ann, lengths, clip


def _args(froot, out, clip, *extra):
    return ["--frames-root", str(froot), "--out-root", str(out), "--clip-ckpt", str(clip), "--dtype", "float32",
            *extra]


def test_extract_matches_jax_and_direct_encode(tmp_path, frames_corpus):
    froot, ann, lengths, clip = frames_corpus
    extra = ["--annotations", str(ann), "--batch", "4"]
    assert extract_features.main(_args(froot, tmp_path / "port", clip, *extra, "--device", "cpu")) == 0
    assert jextract.main(_args(froot, tmp_path / "jax", clip, *extra)) == 0

    params, cfg = load_torch_clip_checkpoint(clip)
    assert cfg == CLIP
    src = FrameSource(input_size=cfg.image_resolution)
    for name, n in lengths.items():
        feats = np.load(tmp_path / "port" / f"{name}.npy")
        assert feats.shape == (n, cfg.embed_dim) and feats.dtype == np.float32
        np.testing.assert_allclose(feats, np.load(tmp_path / "jax" / f"{name}.npy"), rtol=0, atol=GOLDEN)
        rec = VideoRecord(rel_path=name, start_frame=1, end_frame=n, label=0, root=str(froot))
        frames = src.gather(rec, np.arange(n))[0]
        with torch.no_grad():
            want = encode_image(params, cfg, torch.from_numpy(frames)).numpy()
        np.testing.assert_allclose(feats, want, rtol=0, atol=1e-6)
        # and the files load through the feature path
        loaded = FeatureSource(ncrops=1).load_video(
            VideoRecord(rel_path=name, start_frame=1, end_frame=n, label=0, root=str(tmp_path / "port")))
        assert loaded.shape == (n, 1, cfg.embed_dim)


def test_extract_ten_crop_layout(tmp_path, frames_corpus):
    froot, ann, _, clip = frames_corpus
    extra = ["--annotations", str(ann), "--ncrops", "10", "--batch", "8"]
    assert extract_features.main(_args(froot, tmp_path / "port", clip, *extra, "--device", "cpu")) == 0
    assert jextract.main(_args(froot, tmp_path / "jax", clip, *extra)) == 0
    feats = np.load(tmp_path / "port" / "vid_a.npy")
    assert feats.shape == (7, 10, CLIP.embed_dim)
    np.testing.assert_allclose(feats, np.load(tmp_path / "jax" / "vid_a.npy"), rtol=0, atol=GOLDEN)
    # FeatureSource's reshape(-1, ncrops, D) reproduces (T, ncrops, D) exactly
    rec = VideoRecord(rel_path="vid_a", start_frame=1, end_frame=7, label=0, root=str(tmp_path / "port"))
    np.testing.assert_array_equal(FeatureSource(ncrops=10).load_video(rec), feats)


def test_extract_discovers_videos_without_annotations(tmp_path, frames_corpus):
    froot, _, lengths, clip = frames_corpus
    out = tmp_path / "features_auto"
    args = _args(froot, out, clip, "--device", "cpu")
    assert extract_features._discover_videos(froot, "{:06d}.jpg") == jextract._discover_videos(froot, "{:06d}.jpg")
    assert extract_features.main(args) == 0
    for name, n in lengths.items():
        assert np.load(out / f"{name}.npy").shape[0] == n

    # skip-existing: a re-run rewrites no file
    mtimes = {name: (out / f"{name}.npy").stat().st_mtime_ns for name in lengths}
    assert extract_features.main(args) == 0
    for name in lengths:
        assert (out / f"{name}.npy").stat().st_mtime_ns == mtimes[name]

    # --overwrite rewrites every file
    assert extract_features.main(args + ["--overwrite"]) == 0
    for name in lengths:
        assert (out / f"{name}.npy").stat().st_mtime_ns != mtimes[name]


def test_feature_writer_on_uint8_arrays(tmp_path):
    """The encode-and-write half alone, from uint8 arrays (no decoder): two
    seeded videos in chunks, equal to the tower's encode of the whole video."""
    params = init_clip_params(torch.Generator().manual_seed(4), CLIP)
    writer = extract_features.FeatureWriter(params, CLIP, torch.float32, "cpu", batch=4)
    rng = np.random.default_rng(1)
    for name, n in (("a", 9), ("b", 3)):
        video = rng.integers(0, 256, (1, n, 32, 32, 3), dtype=np.uint8)
        parts = [writer.encode(video[:, lo:lo + 4]) for lo in range(0, n, 4)]
        feats = writer.write(tmp_path / f"{name}.npy", parts)
        with torch.no_grad():
            want = encode_image(params, CLIP, torch.from_numpy(video[0])).numpy()
        assert feats.shape == (n, CLIP.embed_dim)
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}.npy"), feats)
        np.testing.assert_allclose(feats, want, rtol=0, atol=1e-6)
    assert writer.frames == 12 and not list(tmp_path.glob("*.tmp.npy"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            extract_features.main(["--frames-root", str(tmp_path), "--out-root", str(tmp_path / "o")])

