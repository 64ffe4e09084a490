"""Tiny cells for the CPU tests: the real configurations cut to a few layers of
small width and the real mixes cut to a few short videos and small batches, so
that a whole run, reference and all, takes seconds on the CPU."""

from __future__ import annotations

import copy

from benchmark.cells import Cell, load_config, load_mix, prepare_config

TINY_CLIP = {"embed_dim": 64, "image_resolution": 32, "vision_layers": 2, "vision_width": 64,
             "vision_patch_size": 16, "context_length": 77, "vocab_size": 49408,
             "transformer_width": 64, "transformer_heads": 4, "transformer_layers": 2}


def tiny_config(name: str = "ucfcrime-vitb16", **model) -> dict:
    cfg = copy.deepcopy(load_config(name))
    cfg["name"] = f"tiny-{name}"
    cfg["clip"] = dict(TINY_CLIP)
    cfg["model"].update({"emb_size": 32, "heads": 4, "num_segments": 4, "seg_length": 4, **model})
    cfg["loss"].update({"frames_per_segment": 4, "num_segments": 4})
    cfg["epoch_steps"] = 2
    cfg["check_grids"] = 3
    return prepare_config(cfg)


def tiny_cell(kind: str = "clips", limits=None, config: str = "ucfcrime-vitb16", **model) -> Cell:
    cfg = tiny_config(config, **model)
    if kind == "clips":
        mix = load_mix("clips")
        mix.update({"lengths": [40, 17, 5], "pool_frames": 48, "cycles": 2, "trace_videos": 4})
        end_to_end = ["frames_per_s", "setup_s"]
        limits = limits or {"score_gap": 1e-4, "prob_gap": 1e-4}
    else:
        mix = load_mix("train-inmem")
        mix.update({"pool_batches": 4, "half_batch": 4, "start_epoch": 5, "trace_steps": 2})
        end_to_end = ["train_step_ms", "setup_s"]
        limits = limits or {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3}
    return Cell(name=f"tiny-{kind}", config=cfg, mix=mix, chips=1, end_to_end=end_to_end, per_layer=[],
                limits=dict(limits))
