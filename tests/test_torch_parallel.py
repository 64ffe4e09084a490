"""The port's data-parallel pieces (parallel/mesh.py and the model and
evaluator code that runs under a group) against the JAX package, on the CPU.

- ``usable_data_devices`` against the JAX function on the same device lists,
  and its refusal of a half-batch a joined group does not divide;
- ``init_distributed`` outside a group, and NCCL refused without a card of its
  own for every rank, naming the gloo route;
- over 2 gloo ranks (tests/helpers/torch_ranks.py), each rank holding its block
  of the global batch:
  * sync-BN (``batch_norm_apply(..., dp=)``) against the JAX
    ``batch_norm_apply`` on the global batch: normalized output, running
    statistics and the input gradient at 1e-4;
  * the smoothness term across the rank boundary and the whole
    ``compute_loss`` against the JAX package's on the global batch: each term
    the mean of the ranks' (the smoothness the same on both), at rtol 2e-4,
    and each rank's gradient over the ranks against ``jax.grad``;
  * ``selector_train``'s dropout masks drawn for the global batch and sliced:
    the ranks' indices equal one process's on the global batch;
  * the skewed-shard gather: 5 videos of unequal length, 2 ranks, a gather
    chunk of 8 frames (below the longest video's 40), equal to one-process
    ``evaluate_videos`` to the bit; one rank stopping gives {} on both;
  * the host collectives ``any_rank``, ``every_rank``, ``sum_f64``,
    ``allgather_host``, ``mean_gradients_`` and ``broadcast_``.
"""

from __future__ import annotations

import importlib.util
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomalyclip_tpu.models import losses as jloss
from anomalyclip_tpu.models import selector as jsel
from anomalyclip_tpu.parallel.mesh import usable_data_devices as jax_usable
from anomalyclip_tpu_torch.parallel import mesh

HELPERS = Path(__file__).resolve().parent / "helpers"
_spec = importlib.util.spec_from_file_location("_test_torch_parallel_ranks", HELPERS / "torch_ranks.py")
ranks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks)

P = 2
N_SEG, SEG_LEN, TOPK = 8, 4, 2
NORMAL_ID, NUM_CLASSES = 2, 4
HALF = 4  # videos per half of the global batch
VIDEO_LENGTHS = (31, 5, 17, 2, 40)
GATHER_CHUNK = 8


# ---------------------------------------------------------------------------
# the mesh rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("half_batch", [1, 2, 3, 4, 6, 8, 12, 16, 32])
def test_usable_data_devices_matches_jax(half_batch, n_devices):
    devices = list(range(n_devices))
    assert mesh.usable_data_devices(half_batch, devices) == jax_usable(half_batch, devices)


def test_a_single_process_does_not_initialize(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.init_distributed() is False and not mesh.distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_distributed(device="cpu") is False and not mesh.distributed()
    assert mesh.rank() == 0 and mesh.world_size() == 1
    assert mesh.rank_device("cpu") == torch.device("cpu")
    assert mesh.rank_device("cuda") == torch.device("cuda")  # outside a group: as given


def test_nccl_without_a_card_of_its_own_raises_naming_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="card of its own.*gloo"):
        mesh.init_distributed(backend="nccl", world_size=2, rank=1, init_method="file:///nonexistent")
    with pytest.raises(RuntimeError, match="NCCL runs on cards"):
        mesh.init_distributed(backend="nccl", device="cpu", world_size=2, rank=0)
    assert not mesh.distributed()


# ---------------------------------------------------------------------------
# the 2-rank run
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent('''
    import os, sys
    from pathlib import Path
    import numpy as np
    import torch
    from anomalyclip_tpu_torch.parallel import mesh
    from anomalyclip_tpu_torch.models import losses, selector as sel
    from anomalyclip_tpu_torch.eval.evaluator import VideoScores, evaluate_videos

    work = Path(sys.argv[1])
    assert mesh.init_distributed(backend="gloo")
    r, P = mesh.rank(), mesh.world_size()
    d = dict(np.load(work / "inputs.npz"))
    res = {}

    def block(a, per_video, half):
        """rank r's rows of a global batch laid out abnormal half first"""
        a = np.asarray(a)
        lo = r * (half // P) * per_video
        n = (half // P) * per_video
        return np.concatenate([a[lo:lo + n], a[half * per_video + lo:half * per_video + lo + n]])

    # sync-BN
    rows = d["bn_logits"].shape[0] // P
    x = torch.tensor(d["bn_logits"][r * rows:(r + 1) * rows], requires_grad=True)
    state = sel.BNState(torch.from_numpy(d["bn_mean"]), torch.from_numpy(d["bn_var"]))
    normed, new = sel.batch_norm_apply(x, state, True, momentum=0.1, eps=1e-5, dp=(r, P))
    (normed * torch.from_numpy(d["bn_w"][r * rows:(r + 1) * rows])).sum().backward()
    res.update(bn_normed=normed.detach().numpy(), bn_grad=x.grad.numpy(),
               bn_mean=new.mean.numpy(), bn_var=new.var.numpy())

    # compute_loss on this rank's block
    half, nl, kl = int(d["half"]), int(d["nl"]), int(d["kl"])
    cfg = losses.LossConfig(normal_id=int(d["normal_id"]), num_topk=int(d["topk"]),
                            frames_per_segment=int(d["seg_len"]), num_segments=int(d["n_seg"]))
    sim = torch.tensor(block(d["sim"], nl, half), requires_grad=True)
    sim_topk = torch.tensor(block(d["sim_topk"], kl, half), requires_grad=True)
    scores = torch.tensor(block(d["scores"], nl, half), requires_grad=True)
    labels = torch.from_numpy(block(d["labels"], 1, half))
    lh = half // P
    idx = [torch.from_numpy(d[k][r * lh:(r + 1) * lh]).long() for k in ("idx_ta", "idx_tn", "idx_ba")]
    terms = losses.compute_loss(sim, sim_topk, labels, scores, *idx, cfg, dp=(r, P))
    terms.total.backward()
    res.update(terms=np.array([float(t) for t in terms]), g_sim=sim.grad.numpy(),
               g_sim_topk=sim_topk.grad.numpy(), g_scores=scores.grad.numpy())
    glob = losses.global_abnormal_scores(torch.from_numpy(block(d["scores"], nl, half)[:lh * nl]), (r, P))
    res["global_abn"] = glob.numpy()

    # the dropout masks: the global batch's, sliced
    scfg = sel.SelectorConfig(normal_id=int(d["normal_id"]), num_segments=int(d["n_seg"]),
                              seg_length=int(d["seg_len"]), num_topk=int(d["topk"]), num_bottomk=int(d["topk"]),
                              select_idx_dropout_topk=0.5, select_idx_dropout_bottomk=0.3)
    feats = torch.from_numpy(block(d["feats"], nl, half))
    text, nc = torch.from_numpy(d["text"]), torch.from_numpy(d["nc"])
    sel_state = sel.BNState.create(text.shape[0] - 1)
    mine, _ = sel.selector_train(feats, text, labels, nc, sel_state, torch.Generator().manual_seed(5), scfg, dp=(r, P))
    alone, _ = sel.selector_train(torch.from_numpy(d["feats"]), text, torch.from_numpy(d["labels"]), nc, sel_state,
                                  torch.Generator().manual_seed(5), scfg)
    for k in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
        res["mask_" + k] = getattr(mine, k).numpy()
        res["alone_" + k] = getattr(alone, k)[r * lh:(r + 1) * lh].numpy()

    # the skewed-shard gather
    lengths = [int(n) for n in d["lengths"]]

    def video(k):
        g = np.random.default_rng(k)
        t = lengths[k]
        probs = g.random((t, 3)).astype(np.float32)
        return VideoScores(probs[:, 0] * 2, g.random(t).astype(np.float32), probs, g.integers(0, 4, t), k % 3,
                           f"v{k}")

    class Strided:
        def __init__(self, p, count):
            self.p, self.count = p, count
        def global_indices(self):
            return range(self.p, len(lengths), self.count)
        def __iter__(self):
            return iter(self.global_indices())

    os.environ["ANOMALYCLIP_GATHER_CHUNK"] = str(int(d["chunk"]) + 16 * r)  # the ranks take the smallest
    got = evaluate_videos(Strided(r, P), score_item=video, gather_processes=True)
    want = evaluate_videos(range(len(lengths)), score_item=video)
    for k in want:
        res["gather_" + k], res["alone_gather_" + k] = got[k], want[k]
    calls = []
    stopped = evaluate_videos(Strided(r, P), score_item=video, gather_processes=True,
                              should_stop=lambda: r == 1 and calls.append(1) is None)
    res["stopped_empty"] = np.array(stopped == {})
    res["tp_follower"] = np.array(evaluate_videos(Strided(r, P), score_item=video, gather_processes=True,
                                                  contribute=r == 0)["abnormal_scores"].size)

    # host collectives
    res["any"] = np.array([mesh.any_rank(r == 1), mesh.any_rank(False), mesh.every_rank(r == 1),
                           mesh.every_rank(True)])
    res["sum_f64"] = mesh.sum_f64([r + 0.5, 1e-17])
    res["gathered"] = mesh.allgather_host(np.array([r, 10 * r], np.int64))
    w = torch.full((3,), float(r + 1), requires_grad=True)
    (w * (r + 1)).sum().backward()
    mesh.mean_gradients_([w])
    res["mean_grad"] = w.grad.numpy()
    t = torch.full((2,), float(r + 7))
    mesh.broadcast_([t])
    res["broadcast"] = t.numpy()
    np.savez(work / f"rank{r}.npz", **res)
''')


def _block(a, per_video):
    """The global array laid out abnormal half first -> rank blocks in rank order."""
    lh = HALF // P
    parts = []
    for r in range(P):
        lo = r * lh * per_video
        parts.append(np.concatenate([a[lo:lo + lh * per_video],
                                     a[HALF * per_video + lo:HALF * per_video + lo + lh * per_video]]))
    return parts


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    nl, kl, c = N_SEG * SEG_LEN, TOPK * SEG_LEN, NUM_CLASSES - 1
    b = 2 * HALF
    labels = np.array([0, 1, 3, 1] + [NORMAL_ID] * HALF, np.int64)
    idx = [np.stack([rng.permutation(N_SEG)[:TOPK] for _ in range(HALF)]).astype(np.int64) for _ in range(3)]
    inputs = dict(
        bn_logits=rng.standard_normal((12, 3)).astype(np.float32) * 2 + 1,
        bn_mean=rng.standard_normal(3).astype(np.float32), bn_var=rng.random(3).astype(np.float32) + 0.5,
        bn_w=rng.standard_normal((12, 3)).astype(np.float32),
        sim=rng.standard_normal((b * nl, c)).astype(np.float32),
        sim_topk=rng.standard_normal((b * kl, c)).astype(np.float32),
        scores=rng.random(b * nl).astype(np.float32), labels=labels,
        idx_ta=idx[0], idx_tn=idx[1], idx_ba=idx[2],
        feats=rng.standard_normal((b * nl, 16)).astype(np.float32),
        text=rng.standard_normal((NUM_CLASSES, 16)).astype(np.float32),
        nc=rng.standard_normal(16).astype(np.float32),
        half=HALF, nl=nl, kl=kl, normal_id=NORMAL_ID, topk=TOPK, seg_len=SEG_LEN, n_seg=N_SEG,
        lengths=np.array(VIDEO_LENGTHS), chunk=GATHER_CHUNK,
    )
    np.savez(work / "inputs.npz", **inputs)
    ranks.run(_RANK, P, work, args=[work])
    out = [dict(np.load(work / f"rank{r}.npz")) for r in range(P)]
    return inputs, out


def test_sync_bn_matches_jax_on_the_global_batch(run):
    inputs, out = run
    x, w = jnp.asarray(inputs["bn_logits"]), jnp.asarray(inputs["bn_w"])
    state = jsel.BNState(jnp.asarray(inputs["bn_mean"]), jnp.asarray(inputs["bn_var"]))
    normed, new = jsel.batch_norm_apply(x, state, training=True)
    grad = jax.grad(lambda v: jnp.sum(jsel.batch_norm_apply(v, state, training=True)[0] * w))(x)
    np.testing.assert_allclose(np.concatenate([o["bn_normed"] for o in out]), normed, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.concatenate([o["bn_grad"] for o in out]), grad, rtol=1e-4, atol=1e-4)
    for o in out:  # the running statistics, the global count's unbiased variance, on every rank
        np.testing.assert_allclose(o["bn_mean"], new.mean, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(o["bn_var"], new.var, rtol=1e-4, atol=1e-6)


def test_global_abnormal_scores_pair_across_the_rank_boundary(run):
    inputs, out = run
    want = inputs["scores"][: HALF * N_SEG * SEG_LEN]
    for o in out:
        np.testing.assert_array_equal(o["global_abn"], want)
    # rank 0's last score pairs with rank 1's first, only the last pairs with itself
    got = float(jloss._smoothness(jnp.asarray(out[0]["global_abn"])))
    halves = [jloss._smoothness(jnp.asarray(p)) for p in np.split(want, P)]
    boundary = (want[len(want) // 2] - want[len(want) // 2 - 1]) ** 2
    assert got == pytest.approx(float(sum(halves)) + float(boundary), rel=1e-5)


def test_compute_loss_across_ranks_matches_jax(run):
    inputs, out = run
    cfg = jloss.LossConfig(normal_id=NORMAL_ID, num_topk=TOPK, frames_per_segment=SEG_LEN, num_segments=N_SEG)
    args = [jnp.asarray(inputs[k]) for k in ("sim", "sim_topk", "labels", "scores", "idx_ta", "idx_tn", "idx_ba")]
    want = jloss.compute_loss(*args, cfg)
    got = np.mean([o["terms"] for o in out], axis=0)
    np.testing.assert_allclose(got, [float(t) for t in want], rtol=2e-4, atol=1e-6)
    # the smoothness is the global batch's on every rank
    np.testing.assert_allclose([o["terms"][6] for o in out], float(want.lsmooth), rtol=1e-5)

    def total(sim, sim_topk, scores):
        return jloss.compute_loss(sim, sim_topk, args[2], scores, *args[4:], cfg).total

    grads = jax.grad(total, argnums=(0, 1, 2))(args[0], args[1], args[3])
    per_video = {"g_sim": N_SEG * SEG_LEN, "g_sim_topk": TOPK * SEG_LEN, "g_scores": N_SEG * SEG_LEN}
    for (key, n), want_g in zip(per_video.items(), grads):
        for r, (o, w) in enumerate(zip(out, _block(np.asarray(want_g), n))):
            # the mean of the ranks' gradients is the global gradient
            np.testing.assert_allclose(o[key] / P, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=f"{key} {r}")


def test_dropout_masks_are_the_global_batchs(run):
    _, out = run
    for o in out:
        for k in ("idx_topk_abn", "idx_topk_nor", "idx_bottomk_abn"):
            np.testing.assert_array_equal(o["mask_" + k], o["alone_" + k], err_msg=k)


def test_skewed_shard_gather_equals_one_process_to_the_bit(run):
    _, out = run
    assert max(VIDEO_LENGTHS) > GATHER_CHUNK
    for o in out:
        for k in ("abnormal_scores", "labels", "class_probs"):
            got, want = o["gather_" + k], o["alone_gather_" + k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert bool(o["stopped_empty"])
        # a rank that does not contribute (a tensor-parallel follower) adds none
        assert int(o["tp_follower"]) == sum(VIDEO_LENGTHS[0::P])


def test_host_collectives(run):
    _, out = run
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["any"], [True, False, False, True])
        np.testing.assert_array_equal(o["sum_f64"], [0.5 + 1.5, 2e-17])
        np.testing.assert_array_equal(o["gathered"], [[0, 0], [1, 10]])
        np.testing.assert_array_equal(o["mean_grad"], np.full(3, 1.5, np.float32))
        np.testing.assert_array_equal(o["broadcast"], np.full(2, 7.0, np.float32))


def test_a_joined_group_refuses_a_half_batch_it_does_not_divide(monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="must divide evenly over 2 ranks"):
        mesh.usable_data_devices(3, [0, 1, 2])
    assert mesh.usable_data_devices(4, [0, 1, 2]) == [0, 1, 2]
