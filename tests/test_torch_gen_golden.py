"""The port's gen_golden against the committed fixtures of tests/golden/ (the
JAX package's), on the CPU.

- The CLI once (a module fixture), every writer but ``clip_b16``, ``tiny``
  from a reference Lightning ``.ckpt`` built from the golden tiny state by
  ``convert_ckpt.lightning_state_dict``: no miss of the script's own
  comparisons; ``tokenizer.npz``, ``tiny_state.npz`` and ``metrics.npz`` equal
  to the committed ones (metrics at 1e-9), ``tiny_pipeline.npz`` at
  tests/test_golden.py's tolerances.
- ``tiny`` again from ``--tiny-state`` (the committed state), against the
  committed pipeline and against the pipeline from the ``.ckpt``.
- ``clip_b16`` on the JAX package's ``init_clip_params(PRNGKey(0))`` weights
  carried by ``convert.params_from_jax`` (tests/test_torch_clip.py's pattern):
  the features at 1e-4, the inputs exact.
- The ``.ckpt`` built from the golden state converts back to it, by the port's
  converter and by the JAX package's.
- The copies of tests/helpers/golden_inputs.py equal the originals; a miss
  exits 1; ``--out`` may not be tests/golden.
"""

from __future__ import annotations

import importlib.util
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from anomalyclip_tpu import convert_ckpt as jconvert_ckpt
from anomalyclip_tpu.models.clip import model as jclip
from anomalyclip_tpu.utils.treeio import flatten_tree
from anomalyclip_tpu_torch import convert
from anomalyclip_tpu_torch.convert_ckpt import convert_lightning_checkpoint, lightning_state_dict
from anomalyclip_tpu_torch.models.clip import model as tclip
from anomalyclip_tpu_torch.scripts import gen_golden as gg

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"


def _golden_inputs():
    """tests/helpers/golden_inputs.py loaded by its path (an installed package
    named ``tests`` may shadow this repository's)."""
    spec = importlib.util.spec_from_file_location("_test_torch_gen_golden_inputs",
                                                  ROOT / "tests" / "helpers" / "golden_inputs.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load(path: Path) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _golden_trees():
    return convert.state_from_flat(_load(GOLDEN / "tiny_state.npz"), device="cpu")


def _write_ckpt(path: Path) -> Path:
    frozen, trainable, bn, _ = _golden_trees()
    torch.save({"state_dict": lightning_state_dict(frozen, trainable, bn), "epoch": 0}, str(path))
    return path


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen_golden")
    ckpt = _write_ckpt(tmp / "tiny.ckpt")
    held = gg.main(["--out", str(tmp / "out"), "--device", "cpu", "--only", "tokenizer", "tiny", "metrics",
                    "--tiny-ckpt", str(ckpt)])
    return tmp / "out", held


def test_the_scripts_comparisons_all_hold(written):
    out, held = written
    assert held.misses == [] and held.count > 70, held.misses
    assert sorted(p.name for p in out.iterdir()) == ["metrics.npz", "tiny_pipeline.npz", "tiny_state.npz",
                                                     "tokenizer.npz"]


@pytest.mark.parametrize("name", ["tokenizer.npz", "tiny_state.npz", "metrics.npz"])
def test_written_fixture_equals_the_committed_one(written, name):
    got, want = _load(written[0] / name), _load(GOLDEN / name)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if name == "metrics.npz" and key in ("expected", "mc_auroc", "mc_aupr"):
            np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-9, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def _assert_pipeline(got: dict, want: dict) -> None:
    """tests/test_golden.py's tolerances."""
    np.testing.assert_allclose(got["ncentroid"], want["ncentroid"], rtol=1e-5, atol=1e-5)
    for key in ("logits", "logits_topk", "scores"):
        np.testing.assert_allclose(got[f"train/{key}"], want[f"train/{key}"], rtol=1e-4, atol=2e-5, err_msg=key)
    for key in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        np.testing.assert_array_equal(got[f"train/{key}"], want[f"train/{key}"], err_msg=key)
    for key in ("bn_mean", "bn_var"):
        np.testing.assert_allclose(got[f"train/{key}"], want[f"train/{key}"], rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["train/loss_terms"], want["train/loss_terms"], rtol=2e-4, atol=1e-5)
    np.testing.assert_array_equal(got["eval/labels"], want["eval/labels"])
    for key in ("eval/abnormal_scores", "eval/class_probs"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=2e-5, err_msg=key)
    np.testing.assert_allclose(got["eval/metrics"], want["eval/metrics"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["steps/losses"], want["steps/losses"], rtol=5e-4, atol=1e-5)
    after = sorted(k for k in want if k.startswith("steps/after3/"))
    assert after and after == sorted(k for k in got if k.startswith("steps/after3/"))
    for key in after:
        diff = np.abs(got[key] - want[key])
        np.testing.assert_array_less(diff.max(), 2 * 1e-3 * 3, err_msg=key)
        assert (diff <= 5e-5 + 1e-3 * np.abs(want[key])).mean() >= 0.999, key
    for key in ("steps/bn_mean", "steps/bn_var"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)
    assert got.keys() == want.keys()


def test_tiny_pipeline_from_the_ckpt_matches_golden(written):
    _assert_pipeline(_load(written[0] / "tiny_pipeline.npz"), _load(GOLDEN / "tiny_pipeline.npz"))


def test_tiny_pipeline_from_tiny_state_matches_golden_and_the_ckpts(written, tmp_path):
    held = gg.main(["--out", str(tmp_path), "--device", "cpu", "--only", "tiny", "--tiny-state",
                    str(GOLDEN / "tiny_state.npz")])
    assert held.misses == [] and sorted(p.name for p in tmp_path.iterdir()) == ["tiny_pipeline.npz"]
    got = _load(tmp_path / "tiny_pipeline.npz")
    _assert_pipeline(got, _load(GOLDEN / "tiny_pipeline.npz"))
    _assert_pipeline(got, _load(written[0] / "tiny_pipeline.npz"))


def test_clip_b16_on_the_jax_weights_matches_golden(tmp_path):
    cfg = jclip.CLIPConfig.vit_b16()
    jparams = jax.tree_util.tree_map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), cfg))
    params = convert.params_from_jax(jparams, device="cpu")
    held = gg.Held()
    fixture = gg.gen_clip_b16(tmp_path, held, params, tclip.CLIPConfig.vit_b16(), "cpu", GOLDEN, is_golden=True)
    assert held.misses == [] and held.count == 6, held.misses
    got, want = _load(tmp_path / "clip_b16.npz"), _load(GOLDEN / "clip_b16.npz")
    assert got.keys() == want.keys() == fixture.keys()
    for key in ("image_u8", "text_ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)


def test_the_ckpt_of_the_golden_state_converts_back_to_it(tmp_path):
    """By the port's converter, to the bit, and by the JAX package's, to the
    committed flat state (its token rows were zeroed before it was written)."""
    frozen, trainable, bn, _ = _golden_trees()
    ckpt = _write_ckpt(tmp_path / "tiny.ckpt")
    got = convert_lightning_checkpoint(ckpt)
    for a, b in zip(convert.tree_leaves([frozen, trainable]), convert.tree_leaves(list(got[:2]))):
        assert torch.equal(a.detach(), b)
    assert torch.equal(got[2].mean, bn.mean) and torch.equal(got[2].var, bn.var)
    jfrozen, jtrainable, jbn = jconvert_ckpt.convert_lightning_checkpoint(ckpt)
    flat = {**flatten_tree(jax.tree_util.tree_map(np.asarray, jfrozen), "frozen"),
            **flatten_tree(jax.tree_util.tree_map(np.asarray, jtrainable), "trainable"),
            "bn/mean": np.asarray(jbn.mean), "bn/var": np.asarray(jbn.var)}
    want = {k: v for k, v in _load(GOLDEN / "tiny_state.npz").items() if not k.startswith("clip_cfg/")}
    assert flat.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)


@pytest.mark.parametrize("args", [(6, 2, 4, 3, 16), (14, 7, 32, 16, 64)])
def test_golden_input_copies_equal_the_originals(args):
    original = _golden_inputs()
    for got, want in zip(gg.train_forward_inputs(*args), original.train_forward_inputs(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for (f, y), (wf, wy) in zip(gg.trajectory_batches(*args), original.trajectory_batches(*args), strict=True):
        np.testing.assert_array_equal(f, wf)
        np.testing.assert_array_equal(y, wy)
    assert gg.abnormal_classes(*args[:2]) == original.abnormal_classes(*args[:2])


def test_a_miss_exits_one(tmp_path, capsys):
    against = tmp_path / "against"
    against.mkdir()
    for name in ("tokenizer.npz", "metrics.npz"):
        shutil.copy(GOLDEN / name, against / name)
    metrics = _load(against / "metrics.npz")
    metrics["expected"] = metrics["expected"] + 1e-6  # past the 1e-9 tolerance
    np.savez_compressed(against / "metrics.npz", **metrics)
    with pytest.raises(SystemExit) as exc:
        gg.main(["--out", str(tmp_path / "out"), "--device", "cpu", "--only", "tokenizer", "metrics",
                 "--against", str(against)])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert "MISS metrics.npz expected" in err and "tokenizer" not in err


def test_out_may_not_be_the_committed_directory():
    with pytest.raises(SystemExit, match="committed fixtures"):
        gg.main(["--out", str(GOLDEN), "--device", "cpu", "--only", "metrics"])
