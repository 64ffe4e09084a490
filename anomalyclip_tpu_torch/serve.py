"""Persistent scoring service: stream videos through one warm scorer. The
counterpart of anomalyclip_tpu/serve.py.

The process keeps the checkpoint, the text features and the built kernels warm
across inputs, and decodes the next input on the host while the current one
scores on the card (one decode slot ahead):

    # score paths fed line by line on stdin (EOF ends the service)
    ls videos/*.mp4 | python -m anomalyclip_tpu_torch.serve model=anomaly_clip_ucfcrime \\
        data=ucfcrime ckpt_path=<ckpt> output_dir=scores/

    # watch a directory, scoring new inputs as they appear
    python -m anomalyclip_tpu_torch.serve ... watch=incoming/ poll_interval=2 [stop_after=60]

    # deploy from an exported serving artifact: no config, checkpoint or model code
    python -m anomalyclip_tpu_torch.serve artifact=<dir> watch=incoming/ output_dir=scores/

Inputs are anything predict.py takes (video file, frames dir, feature .npy);
one ``<stem>.json`` per input lands in ``output_dir``, with predict.py's
schema. An input that fails to load or score is logged to stderr and skipped:
one bad input does not stop the service. On the card unless ``trainer=cpu``.

Under ``torchrun`` (a group of ranks, ``trainer.model_parallel=mp`` scoring
frames through the tensor-parallel tower) rank 0 alone reads the stdin or the
watched directory and hands each path, in its order, to every rank; the ranks
score each input together, skip it together when a rank cannot load it, and
rank 0 writes its JSON.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from anomalyclip_tpu_torch.predict import (
    VIDEO_EXTS,
    _load_input,
    artifact_bootstrap,
    cli_device,
    join_group,
    load_module_and_state,
    score_input,
)
from anomalyclip_tpu_torch.parallel.mesh import broadcast_object, every_rank, rank, world_size
from anomalyclip_tpu_torch.utils.logging import is_host_zero

# seconds rank 0 lets pass without a path before it tells the other ranks to
# wait on: their wait for the next path stays far inside a collective's timeout
HEARTBEAT_S = 5.0


def _iter_stdin():
    for line in sys.stdin:
        line = line.strip()
        if line:
            yield Path(line)


def _iter_watch(root: Path, poll_interval: float, stop_after: float):
    """Yield new scoreable entries of ``root`` as they appear and settle.

    A file is settled once its mtime is a poll interval old; a frames
    directory once its (mtime, entry count) is the same at two polls, so a
    directory still being filled is not scored in part. ``stop_after`` bounds
    the service's life in seconds (0: forever)."""
    seen = set()
    pending: dict = {}  # path -> last observed signature, for settle detection
    deadline = time.time() + stop_after if stop_after else None
    while deadline is None or time.time() < deadline:
        for p in sorted(root.iterdir()):
            try:
                if p in seen or not (
                    p.suffix == ".npy" or p.suffix.lower() in VIDEO_EXTS or p.is_dir()
                ):
                    continue
                if p.is_file():
                    if time.time() - p.stat().st_mtime < poll_interval:
                        continue
                else:
                    sig = (p.stat().st_mtime, sum(1 for _ in p.iterdir()))
                    if pending.get(p) != sig:
                        pending[p] = sig
                        continue
            except OSError:
                # the entry vanished (an atomic rename, a clean-up) between the
                # listing and the stat: drop its settle state and move on
                pending.pop(p, None)
                continue
            pending.pop(p, None)
            seen.add(p)
            yield p
        time.sleep(poll_interval)


def _shared_stream(paths):
    """The paths of rank 0's ``paths``, in its order, on every rank of the
    group. Rank 0 reads ``paths`` on a thread and broadcasts each one, an empty
    string after ``HEARTBEAT_S`` without one, and None at the end (re-raising
    there what the reading raised)."""
    feed: queue.Queue = queue.Queue()
    if rank() == 0:

        def read():
            try:
                for p in paths:
                    feed.put(str(p))
                feed.put(None)
            except BaseException as exc:  # handed to the main thread
                feed.put(exc)

        threading.Thread(target=read, daemon=True).start()
    while True:
        item = None
        if rank() == 0:
            try:
                item = feed.get(timeout=HEARTBEAT_S)
            except queue.Empty:
                item = ""
        failed = item if isinstance(item, BaseException) else None
        item = broadcast_object(None if failed else item)
        if item is None:
            if failed:
                raise failed
            return
        if item:
            yield Path(item)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    if "artifact" in kv:
        # deployment mode: the exported artifact is the whole contract
        art, data_cfg = artifact_bootstrap(kv, cli_device(argv))
        enc = art.meta.get("encode")
        input_size = int(enc["resolution"]) if enc else 0
        cfg = kv
        score_fn = art.predict
    else:
        from anomalyclip_tpu_torch.train_entry import choose_device

        os.environ.setdefault("PROJECT_ROOT", str(Path(__file__).resolve().parents[1]))

        from anomalyclip_tpu_torch.config import compose, default_config_dir, to_dict

        cfg = compose(default_config_dir(), "eval", argv)
        ckpt_path = cfg.get("ckpt_path")
        if not cfg.get("data") or not cfg.get("model") or not ckpt_path or ckpt_path == "???":
            raise SystemExit(
                "serve needs model=... data=... ckpt_path=... (or artifact=<dir>) "
                "[watch=<dir> | paths on stdin] [output_dir=...]"
            )
        module, state = load_module_and_state(to_dict(cfg), join_group(choose_device(argv, cfg)))
        data_cfg = cfg["data"]
        input_size = int(module.model.clip_cfg.image_resolution)

        def score_fn(raw, path):
            return score_input(module, state, raw, path)[1]

    out_dir = Path(cfg.get("output_dir") or "predictions")
    out_dir.mkdir(parents=True, exist_ok=True)

    watch = cfg.get("watch")
    paths = (
        _iter_watch(Path(watch), float(cfg.get("poll_interval", 2.0)), float(cfg.get("stop_after", 0)))
        if watch
        else _iter_stdin()
    )
    if world_size() > 1:
        paths = _shared_stream(paths)

    n_done = 0
    t0 = time.time()
    # one decode slot ahead of the card: the next input loads while this one scores
    with ThreadPoolExecutor(max_workers=1) as decode_pool:
        pending = None  # (path, Future)

        def submit(p):
            return (p, decode_pool.submit(_load_input, p, data_cfg, input_size))

        for p in paths:
            if pending is None:
                pending = submit(p)
                continue
            path, fut = pending
            pending = submit(p)
            _finish(score_fn, path, fut, out_dir)
            n_done += 1
        if pending is not None:
            path, fut = pending
            _finish(score_fn, path, fut, out_dir)
            n_done += 1
    print(f"served {n_done} inputs in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


def _finish(score_fn, path: Path, fut, out_dir: Path) -> None:
    """Score one decoded input and write its JSON. score_fn: (raw, path) ->
    predictions dict (checkpoint- or artifact-backed). A failure is logged and
    the input skipped: the service goes on (the JAX package's contract). In a
    group, an input that a rank could not load is skipped on every rank."""
    try:
        raw, error = fut.result(), None
    except Exception as e:  # one bad input must not stop the service
        raw, error = None, e
    if not every_rank(error is None):
        error = error or RuntimeError("another rank could not load it")
        print(f"ERROR {path}: {type(error).__name__}: {error}", file=sys.stderr)
        return
    try:
        result = score_fn(raw, str(path))
    except Exception as e:
        print(f"ERROR {path}: {type(e).__name__}: {e}", file=sys.stderr)
        return
    out = out_dir / (path.stem + ".json")
    if is_host_zero():  # in a group every rank scores, rank 0 writes
        out.write_text(json.dumps(result))
    print(
        f"{path}: {result['num_frames']} frames, "
        f"score {result['video_anomaly_score']:.4f} -> {out}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    sys.exit(main())
