"""The port's verify_released_ckpts, on the CPU: the ports of
tests/test_verify_released.py's cases, its table and exit codes against the
JAX script's, and ``download_bundle``'s sha256 check.

The dry runs evaluate the golden tiny state over the synthetic corpus with
matplotlib shadowed (``sys.modules["matplotlib"] = None``): the test pass then
writes its metrics and no plots, as on a machine without matplotlib, and the
rehearsal takes a few seconds. No test writes the repository's BASELINE.md:
each passes a table of its own, and the default's path is read from a
replaced ``write_table``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import io
import json
import sys
import urllib.request
import zipfile
from pathlib import Path

import pytest

from anomalyclip_tpu_torch.scripts import verify_released_ckpts as vrc

ROOT = Path(__file__).resolve().parents[1]


def _jax_script():
    """scripts/verify_released_ckpts.py, loaded by its path."""
    spec = importlib.util.spec_from_file_location("_test_torch_verify_jax_script",
                                                  ROOT / "scripts" / "verify_released_ckpts.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def without_plots(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def test_dry_run_writes_table_and_exits_zero(tmp_path, without_plots):
    baseline = tmp_path / "BASELINE.md"
    baseline.write_text("# BASELINE\n\nexisting text\n")
    assert vrc.dry_run(tmp_path / "root", baseline, device="cpu") == 0
    text = baseline.read_text()
    assert "existing text" in text  # the rewrite leaves what is outside the markers
    assert vrc.BEGIN in text and vrc.END in text
    assert "| synthetic | auc_roc |" in text
    assert "**NO**" not in text
    # a second run replaces the marked block instead of appending one
    assert vrc.dry_run(tmp_path / "root2", baseline, device="cpu") == 0
    assert baseline.read_text().count(vrc.BEGIN) == 1


def test_dry_run_perturbed_target_fails_threshold(tmp_path, without_plots):
    baseline = tmp_path / "BASELINE.md"
    # 0.5 pts past the golden AUC trips the 0.2-pt gate
    assert vrc.dry_run(tmp_path / "root", baseline, perturb=0.005, device="cpu") == 1
    assert "**NO**" in baseline.read_text()


def test_checkpoint_location_and_missing_exit(tmp_path):
    assert vrc.find_checkpoint(Path("/nonexistent"), "ucfcrime") is None
    assert vrc.main(["--ckpt-dir", "/nonexistent", "--datasets", "ucfcrime", "--device", "cpu"]) == 2
    # by name anywhere below the directory, else any .ckpt under <dir>/<dataset>
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "AnomalyCLIP_UCFCrime.ckpt").write_bytes(b"")
    (tmp_path / "xdviolence").mkdir()
    (tmp_path / "xdviolence" / "last.ckpt").write_bytes(b"")
    assert vrc.find_checkpoint(tmp_path, "ucfcrime") == tmp_path / "a" / "b" / "AnomalyCLIP_UCFCrime.ckpt"
    assert vrc.find_checkpoint(tmp_path, "xdviolence") == tmp_path / "xdviolence" / "last.ckpt"
    assert vrc.find_checkpoint(tmp_path, "shanghaitech") is None


def test_paper_targets_do_not_gate_exit_code(tmp_path):
    """Only reproduced targets gate the exit code; a paper-only miss is
    reported, and gates only under --strict-paper."""
    datasets = {"fake": {"metric": "m", "reproduced": None, "paper": 0.90}}

    def eval_fn(name):
        return {"m": 0.50}  # 40 points under the paper's number

    baseline = tmp_path / "B.md"
    assert vrc.run(dict(datasets), eval_fn, baseline) == 0
    text = baseline.read_text()
    assert "paper (provisional)" in text and "**NO**" in text
    assert vrc.run(dict(datasets), eval_fn, baseline, strict_paper=True) == 1
    reproduced = {"fake": {"metric": "m", "reproduced": 0.90, "paper": None}}
    assert vrc.run(reproduced, eval_fn, baseline) == 1


def test_table_and_exit_codes_equal_the_jax_scripts(tmp_path, capsys):
    jvrc = _jax_script()
    assert (vrc.DATASETS, vrc.TOLERANCE_PTS, vrc.BEGIN, vrc.END, vrc.RELEASED_BUNDLE) == (
        jvrc.DATASETS, jvrc.TOLERANCE_PTS, jvrc.BEGIN, jvrc.END, jvrc.RELEASED_BUNDLE)
    datasets = {"ucfcrime": dict(vrc.DATASETS["ucfcrime"]), "xdviolence": dict(vrc.DATASETS["xdviolence"]),
                "shanghaitech": dict(vrc.DATASETS["shanghaitech"]),
                "pinned": {"metric": "auc_roc", "reproduced": 0.7, "paper": None}}
    ours = {"ucfcrime": {"auc_roc": 0.8641}, "xdviolence": {"auc_pr": 0.70}, "shanghaitech": {"auc_roc": 0.9},
            "pinned": {"auc_roc": 0.6995}}
    for strict in (False, True):
        tables = []
        for module in (vrc, jvrc):
            path = tmp_path / f"{module.__name__}_{strict}.md"
            path.write_text("# BASELINE\n\nbefore\n\n<!-- verify_released_ckpts:begin -->\nold\n"
                            "<!-- verify_released_ckpts:end -->\nafter\n")
            rc = module.run(dict(datasets), ours.__getitem__, path, strict_paper=strict)
            tables.append((rc, path.read_text()))
        assert tables[0] == tables[1]
        assert tables[0][0] == (1 if strict else 0)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 4 * 4 and lines[:4] == lines[4:8]


def test_a_real_run_gates_on_its_targets_and_defaults_to_the_repos_table(tmp_path, monkeypatch):
    """``main`` over a located checkpoint, its evaluation replaced: a paper
    miss exits 0, and 1 under --strict-paper; the table goes to --baseline-md,
    and by default to the repository's BASELINE.md (read here, not written)."""
    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    (ckpt_dir / "ucfcrime.ckpt").write_bytes(b"not a checkpoint")
    calls = []

    def evaluate(dataset, ckpt, overrides):
        calls.append((dataset, ckpt, overrides))
        return {"auc_roc": 0.5}

    monkeypatch.setattr(vrc, "evaluate_checkpoint", evaluate)
    argv = ["--ckpt-dir", str(ckpt_dir), "--datasets", "ucfcrime", "--device", "cpu", "data.num_workers=0"]
    table = tmp_path / "table.md"
    assert vrc.main([*argv, "--baseline-md", str(table)]) == 0
    assert "| ucfcrime | auc_roc | 0.5000 | 0.8636 | paper (provisional) | 36.360 | **NO** |" in table.read_text()
    assert calls == [("ucfcrime", ckpt_dir / "ucfcrime.ckpt", ["data.num_workers=0", "trainer=cpu"])]
    assert vrc.main([*argv, "--baseline-md", str(table), "--strict-paper"]) == 1
    written = []
    monkeypatch.setattr(vrc, "write_table", lambda path, rows: written.append(path))
    assert vrc.main(argv) == 0
    assert written == [ROOT / "BASELINE.md"]


def test_no_card_refuses_the_default_device(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        vrc.main(["--dry-run"])


class _Response(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _bundle() -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("checkpoints/ucfcrime.ckpt", b"weights")
    return buf.getvalue()


def test_download_bundle_checks_its_sha256(tmp_path, monkeypatch, capsys):
    blob = _bundle()
    digest = hashlib.sha256(blob).hexdigest()
    urls = []
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=0: urls.append(url) or _Response(blob))

    # a pinned hash that differs: refused, the download removed, nothing unpacked
    monkeypatch.setitem(vrc.RELEASED_BUNDLE, "sha256", "0" * 64)
    with pytest.raises(RuntimeError, match="SHA256 mismatch"):
        vrc.download_bundle(tmp_path / "refused")
    assert list((tmp_path / "refused").iterdir()) == []
    assert urls == [f"https://drive.usercontent.google.com/download?id={vrc.RELEASED_BUNDLE['gdrive_id']}"
                    "&export=download&confirm=t"]

    # the pinned hash: unpacked, and found by find_checkpoint
    monkeypatch.setitem(vrc.RELEASED_BUNDLE, "sha256", digest)
    vrc.download_bundle(tmp_path / "pinned")
    assert vrc.find_checkpoint(tmp_path / "pinned", "ucfcrime").read_bytes() == b"weights"

    # unpinned: unpacked, and the hash printed to be committed
    monkeypatch.setitem(vrc.RELEASED_BUNDLE, "sha256", None)
    capsys.readouterr()
    vrc.download_bundle(tmp_path / "unpinned")
    assert f"bundle sha256 (commit into RELEASED_BUNDLE to pin): {digest}" in capsys.readouterr().out
    assert (tmp_path / "unpinned" / "checkpoints" / "ucfcrime.ckpt").is_file()
