"""Export of the serving graphs to a self-contained ``torch.export`` artifact:
the counterpart of anomalyclip_tpu/export.py.

The JAX package serializes two ``jax.export`` graphs and loads them without
any model code. The port's counterpart is ``torch.export``: the serving
functions are traced once into ATen graphs, saved with their weights, and a
``ServingArtifact`` runs them without building the model, reading the config
tree or opening a checkpoint. A saved state would not do: it needs the model
code to run.

Two graphs cover the serving surface (the pair the evaluator, ``predict`` and
``serve`` run, eval/evaluator.py):

- ``score``: (leaves, grids (g, n, l, D)) -> (similarity (g*n*l, C-1), scores
  (g*n*l,)), the trace of ``score_grid_batch``. ``g`` is a ``torch.export.Dim``
  of at least 1, so one artifact scores every video length;
  ``score_grids_bucketed`` keeps the evaluator's bucket padding. The leaves
  are the text features (computed once, at export), the temporal parameters,
  the BN state and the ncentroid.
- ``encode`` (optional): (visual-tower leaves, frames (ENCODE_CHUNK, S, S, 3)
  float32) -> (ENCODE_CHUNK, D) CLIP features, a static chunk.
  ``ServingArtifact.encode`` normalizes uint8 frames on the host
  (``encode_frames_chunked(host_normalize=True)``), as the JAX artifact does.

The attention entries are ``torch.library.custom_op``s (ops/attention.py), so
each graph holds them as single nodes, and they choose when they run: the
hand-written kernels on a CUDA tensor, the plain versions on a CPU tensor. One
difference from the JAX package is deliberate: its score graph is traced under
``attention_impl("xla")``, because a symbolic dimension cannot enter a
``pallas_call`` grid; the port's K2 (``fused_mha_bld``) takes any batch, so the
port's score graph launches K2 on the card, and its encode graph K1. The
kernels' launches count in ``launch_counts`` and ``route_counts`` as anywhere
else. PyTorch's global TF32 switches are no part of a graph: an artifact
runs its graphs under the exporting model's precision policy
(``numerics.matmul_precision_for`` of ``meta["compute_dtype"]``), as the
checkpoint-backed scorer does.

Artifact layout (a directory):

    meta.json           format version, grid, classnames, platforms, torch version
    score.pt2           torch.export serialization of the score graph
    score_params.npz    its leaves (bf16 stored as a uint16 view)
    encode.pt2          (optional) the encode graph
    encode_params.npz   (optional) the frozen visual tower's leaves

CLI (the bootstrap of predict.py; on the card unless ``trainer=cpu``):

    python -m anomalyclip_tpu_torch.export model=anomaly_clip_ucfcrime data=ucfcrime \\
        ckpt_path=<port checkpoint dir | released.ckpt> out=<artifact-dir> \\
        [include_encoder=true] [ncentroid_path=...]

Loading needs the port's ``ops`` package, which registers the operators the
graphs call, and the numpy helpers of ``eval/grids.py`` and ``data/sampling.py``:

    art = ServingArtifact.load("artifact-dir", device="cuda")
    similarity, scores = art.score(grids)          # any g
    feats = art.encode(frames_uint8_or_float)      # chunked, normalized on the host
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

FORMAT_VERSION = 1
# the devices a graph runs on: the operators dispatch on the device they are given
PLATFORMS = ("cpu", "cuda")


def _save_leaves(path: Path, leaves: Sequence[torch.Tensor]) -> None:
    """npz-serialize tensors, spelling bf16 as a uint16 view (npz has no bf16)."""
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        leaf = leaf.detach().cpu()
        dtypes.append(str(leaf.dtype).split(".")[-1])
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.view(torch.uint16)
        arrays[f"leaf_{i}"] = leaf.numpy()
    np.savez(path, __dtypes__=np.array(dtypes), **arrays)


def _load_leaves(path: Path, device) -> List[torch.Tensor]:
    with np.load(path) as z:
        leaves = []
        for i, dt in enumerate(str(d) for d in z["__dtypes__"]):
            leaf = torch.from_numpy(z[f"leaf_{i}"])
            if dt == "bfloat16":
                leaf = leaf.view(torch.bfloat16)
            leaves.append(leaf.to(device))
    return leaves


class _Graph(torch.nn.Module):
    """The function ``fn(leaves, x)`` as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, leaves, x):
        return self.fn(leaves, x)


def _export(fn, leaves: List[torch.Tensor], example: torch.Tensor, dynamic: Optional[dict]):
    """``torch.export`` of ``fn(leaves, x)`` at the example ``x``, without its
    example inputs, which the saved program would otherwise carry (the weights
    go to their own file)."""
    exported = torch.export.export(
        _Graph(fn), (leaves, example), dynamic_shapes=([None] * len(leaves), dynamic)
    )
    exported.example_inputs = None
    return exported


def export_serving_artifact(
    model,
    frozen,
    trainable,
    bn_state,
    ncentroid,
    out_dir: str | Path,
    *,
    include_encoder: bool = True,
    classnames: Optional[Sequence[str]] = None,
) -> Path:
    """Export the serving graphs of a trained AnomalyCLIP to ``out_dir``.

    ``frozen``, ``trainable``, ``bn_state`` and ``ncentroid`` are the trees the
    evaluator reads, on one device (the graphs are traced there). Returns the
    artifact path. The encode graph is the fp tower's, also under
    ``model.net.quantize=int8``: the int8 tower (models/clip/quant.py) is
    quantized where it serves and is not part of an artifact (JAX
    export.py:124-125)."""
    from anomalyclip_tpu_torch.eval.evaluator import GridScorer, score_grid_batch

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = bn_state.mean.device
    scorer = GridScorer(model, frozen, trainable, bn_state, ncentroid, device=device)
    n, l = model.cfg.num_segments, model.cfg.seg_length
    d = model.embedding_dim

    # ---- score graph: a symbolic grid count ------------------------------
    score_leaves, score_spec = pytree.tree_flatten(
        (scorer.text_features, scorer._temporal, scorer._bn_state, scorer._ncentroid)
    )

    def score_flat(leaves, grids):
        text_features, temporal, bn, nc = pytree.tree_unflatten(leaves, score_spec)
        return score_grid_batch(model, text_features, temporal, bn, nc, grids)

    grids = torch.zeros((2, n, l, d), dtype=torch.float32, device=device)
    with torch.no_grad():
        exported = _export(score_flat, score_leaves, grids, {0: torch.export.Dim("g", min=1)})
    torch.export.save(exported, out / "score.pt2")
    _save_leaves(out / "score_params.npz", score_leaves)

    # ---- encode graph: a static chunk -------------------------------------
    encode_meta = None
    if include_encoder:
        chunk = model.ENCODE_CHUNK
        side = int(model.clip_cfg.image_resolution)
        enc_leaves, enc_spec = pytree.tree_flatten(frozen["clip"]["visual"])

        def encode_flat(leaves, frames):
            visual = pytree.tree_unflatten(leaves, enc_spec)
            return model.encode_frames({"clip": {"visual": visual}}, frames)

        frames = torch.zeros((chunk, side, side, 3), dtype=torch.float32, device=device)
        with torch.no_grad():
            exported_enc = _export(encode_flat, enc_leaves, frames, None)
        torch.export.save(exported_enc, out / "encode.pt2")
        _save_leaves(out / "encode_params.npz", enc_leaves)
        encode_meta = {
            "chunk": chunk,
            "resolution": side,
            "embed_dim": int(model.clip_cfg.embed_dim),
            "platforms": list(PLATFORMS),
        }

    meta = {
        "format_version": FORMAT_VERSION,
        "grid": {
            "num_segments": n,
            "seg_length": l,
            "feature_dim": d,
            "stride": int(model.cfg.stride),
        },
        "normal_id": int(model.cfg.normal_id),
        "classnames": list(classnames) if classnames else None,
        "score_platforms": list(PLATFORMS),
        "encode": encode_meta,
        "compute_dtype": model.cfg.compute_dtype,
        "torch_version": torch.__version__,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return out


def _load_graph(path: Path, device):
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(torch.export.load(path), device).module()


class ServingArtifact:
    """A loaded export: ``score`` and, when exported, ``encode``, on one device,
    without the model's code (only the port's ``ops`` package, which registers
    the operators the graphs call, and the numpy helpers of ``eval/grids.py``
    and ``data/sampling.py``)."""

    def __init__(self, meta: dict, score_graph, score_leaves, encode_graph, encode_leaves, device):
        self.meta = meta
        self.device = torch.device(device)
        self._score_graph = score_graph
        self._score_leaves = score_leaves
        self._encode_graph = encode_graph
        self._encode_leaves = encode_leaves

    @classmethod
    def load(cls, path: str | Path, device="cuda") -> "ServingArtifact":
        import anomalyclip_tpu_torch.ops.attention  # noqa: F401 (registers the graphs' operators)

        p = Path(path)
        meta = json.loads((p / "meta.json").read_text())
        if meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {meta['format_version']} is newer than this "
                f"loader ({FORMAT_VERSION})"
            )
        score_graph = _load_graph(p / "score.pt2", device)
        score_leaves = _load_leaves(p / "score_params.npz", device)
        encode_graph = encode_leaves = None
        if (p / "encode.pt2").exists():
            encode_graph = _load_graph(p / "encode.pt2", device)
            encode_leaves = _load_leaves(p / "encode_params.npz", device)
        return cls(meta, score_graph, score_leaves, encode_graph, encode_leaves, device)

    def _precision(self):
        from anomalyclip_tpu_torch.numerics import matmul_precision_for

        return matmul_precision_for(torch.bfloat16 if self.meta.get("compute_dtype") == "bfloat16"
                                    else torch.float32)

    # -- score ---------------------------------------------------------------

    def score(self, grids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """grids (g, n, l, D) float32 -> (similarity (g*n*l, C-1), scores
        (g*n*l,)), any g >= 1 through the one graph."""
        g = self.meta["grid"]
        want = (g["num_segments"], g["seg_length"], g["feature_dim"])
        if tuple(grids.shape[1:]) != want:
            raise ValueError(f"grids shape {grids.shape[1:]} != exported {want}")
        x = torch.from_numpy(np.ascontiguousarray(grids, np.float32)).to(self.device)
        with torch.no_grad(), self._precision():
            sim, sc = self._score_graph(self._score_leaves, x)
        return sim.cpu().numpy(), sc.cpu().numpy()

    # -- encode ----------------------------------------------------------------

    def encode(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 or CLIP-normalized float -> (N, D) features,
        through the chunk, normalize, pad and trim loop the evaluator runs
        (``encode_frames_chunked``), feeding the static-chunk graph float32."""
        if self._encode_graph is None:
            raise ValueError("artifact was exported without the encoder graph")
        from anomalyclip_tpu_torch.eval.grids import encode_frames_chunked

        def encode(part: torch.Tensor) -> torch.Tensor:
            with torch.no_grad(), self._precision():
                return self._encode_graph(self._encode_leaves, part.float())

        return encode_frames_chunked(encode, frames, self.device, chunk=self.meta["encode"]["chunk"],
                                     host_normalize=True)

    # -- full per-video scoring (the predict/serve contract) --------------------

    def score_video(self, raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score one video from the artifact alone: ``raw`` is (ncrops, T, D)
        features or (ncrops, T, H, W, 3) frames (uint8 or CLIP-normalized
        float; needs the encoder graph). The evaluator's pipeline: test-time
        covering sampling, grid layout, crop consensus, stride expansion, trim,
        softmax. -> (similarity (T, C-1), scores (T,), class_probs (T, C-1))."""
        from anomalyclip_tpu_torch.data.sampling import gather_frame_indices, test_start_indices

        g = self.meta["grid"]
        n, l, stride = g["num_segments"], g["seg_length"], g["stride"]
        t_raw = raw.shape[1]
        starts, segment_size = test_start_indices(t_raw, n, l, stride)
        indices = gather_frame_indices(starts, l, stride, t_raw)
        return self._score_sampled(raw[:, indices], segment_size, t_raw)

    def _score_sampled(self, feats: np.ndarray, segment_size: int, num_labels: int):
        """The shared tail of score_video and score_test_item: encode raw frames
        if given, then the evaluator's layout and consensus over the bucketed
        score graph."""
        from anomalyclip_tpu_torch.eval.grids import score_sampled_features

        g = self.meta["grid"]
        if feats.ndim == 5:
            ncrops, t = feats.shape[:2]
            flat = feats.reshape((-1,) + feats.shape[2:])
            feats = self.encode(flat).reshape(ncrops, t, -1)
        return score_sampled_features(
            np.asarray(feats, np.float32), segment_size, g["num_segments"], g["seg_length"],
            g["stride"], num_labels, self.score_grids_bucketed,
        )

    def score_grids_bucketed(self, grids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``score`` with the evaluator's bucket padding, so that the graph sees
        the same grid counts as ``GridScorer`` (and a stream of assorted
        lengths the same handful of shapes)."""
        from anomalyclip_tpu_torch.eval.grids import pad_to_bucket

        padded, true_g = pad_to_bucket(grids)
        sim, sc = self.score(padded)
        n_l = true_g * padded.shape[1] * padded.shape[2]
        return sim[:n_l], sc[:n_l]

    def score_test_item(self, item) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Score a test-sampled ``TestItem`` (data/dataset.py), the benchmark
        path: features (ncrops, n*s*l, ...) with a known segment_size ->
        (similarity, scores, class_probs), trimmed to the labeled length."""
        return self._score_sampled(item.features, item.segment_size, len(item.frame_labels))

    def predict(self, raw: np.ndarray, path: str = "") -> dict:
        """score_video and the predict output schema (the keys and values of the
        checkpoint-backed ``predict.score_input``)."""
        from anomalyclip_tpu_torch.eval.grids import prediction_result

        classnames = self.meta.get("classnames")
        if not classnames:
            raise ValueError(
                "artifact was exported without classnames; re-export passing "
                "classnames= to export_serving_artifact"
            )
        _, sc, class_probs = self.score_video(raw)
        return prediction_result(path, raw.shape[1], sc, class_probs, classnames,
                                 int(self.meta["normal_id"]))


def main(argv=None) -> Path:
    from anomalyclip_tpu_torch.predict import join_group, load_module_and_state
    from anomalyclip_tpu_torch.train_entry import choose_device

    argv = list(sys.argv[1:] if argv is None else argv)
    os.environ.setdefault("PROJECT_ROOT", str(Path(__file__).resolve().parents[1]))

    from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

    cfg = compose(default_config_dir(), "eval", argv)
    if not cfg.get("data") or not cfg.get("model"):
        raise SystemExit(
            "export needs model/data groups, e.g.\n"
            "  python -m anomalyclip_tpu_torch.export model=anomaly_clip_ucfcrime "
            "data=ucfcrime ckpt_path=... out=artifact/"
        )
    ckpt_path = cfg.get("ckpt_path")
    out_dir = cfg.get("out")
    if not ckpt_path or ckpt_path == "???" or not out_dir:
        raise SystemExit("export requires ckpt_path=... and out=...")

    from anomalyclip_tpu_torch.models.anomaly_clip import read_classnames

    module, state = load_module_and_state(to_dict(cfg), join_group(choose_device(argv, cfg)))
    include_encoder = str(cfg.get("include_encoder", True)).lower() not in ("false", "0")
    path = export_serving_artifact(
        module.model,
        module.frozen,
        state.trainable,
        state.bn_state,
        module.ncentroid,
        out_dir,
        include_encoder=include_encoder,
        classnames=read_classnames(module.datamodule.cfg.labels_file),
    )
    print(f"exported serving artifact -> {path}")
    return path


def cli() -> int:
    """Console-script entry: main() returns the artifact Path, which setuptools
    wrappers would pass to sys.exit() — translate to a clean exit status."""
    main()
    return 0


if __name__ == "__main__":
    main()
