"""Data parallelism of the port's AVE training (dg_sct_tpu_torch: parallel.mesh,
parallel.comm, the `group` of ops.basic.batch_norm, dsp.do_mixup and
train.ave_train, ops.draws.RowShard, train.ave_main's world) in gloo worlds
of spawned CPU ranks (tests/torch_parallel_worker.py).

Against the JAX package's one-device `make_train_step` on the global batch
(GSPMD gives its sharded step the same numbers), float32, no generator on
either side, mixup on from given lambdas: two mini-steps of accum 2 on a
global batch of 4 split over 2 ranks. After the first, the loss and every
BN statistic within 1e-5 relative (of each leaf's largest value), and every
element of the all-reduced gradient within 1e-5 of its leaf's largest plus
GRAD_FLOOR of the whole gradient's largest. The floor is float32's: the
rounding of a gradient element follows the sizes of the terms summed into
it, which the tree's largest measures, not the element's leaf (a bias whose
exact gradient is 0, a gate that sums an adapter's output over every token).
JAX holds its own gradient only that far: the same step on the batch with
its clips in reverse order moves elements by more than 1e-5 of their leaf's
largest in many leaves, and `test_jax_meets_the_gradient_bound` holds that
reordered gradient to the same bound. After the second mini-step
(Adam's first update, about lr * sign(g)) each trainable element's move
within 1e-3 relative and 1e-3 * lr, where the reference's first moment is
not small (tests/test_torch_train.py's rule, SMALL_MOMENT); the ranks'
trainable leaves bit for bit equal.

Against the port's own one-process step on the global batch at the same
seed with SpecAugment, drop_path, dropout and mixup on (each rank draws the
global batch's draws and keeps its rows), in float64, where rounding no
longer hides a fault: loss and BN statistics within 1e-10 relative, every
gradient leaf within 1e-10 of its largest but for the leaves whose exact
gradient is 0 (their largest at most ZERO_SHARE of the tree's, in both
steps), the new parameters as above.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import TrainConfig as JTrainConfig
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import ave_train as JT
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.train import ave_main as PMain
from dg_sct_tpu_torch.utils.tree import tree_paths
import torch_parallel_worker as W
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

B = 4                  # the global batch, over 2 ranks
LR = 1e-3
TRAIN_KW = dict(accum_steps=2, lr=LR, lr_mlp=LR)
STAT_RTOL = 1e-5       # loss and BN statistics against JAX, of each leaf's largest
GRAD_TOL = 1e-5        # the all-reduced gradient against JAX's, of each leaf's largest ...
GRAD_FLOOR = 5e-5      # ... plus this share of the whole gradient's largest (float32 rounding)
SELF_RTOL = 1e-10      # float64 DP against the port's one process, of each leaf's largest
ZERO_SHARE = 1e-12     # a float64 leaf no larger than this share of the tree's: exact gradient 0
UPDATE_RTOL = 1e-3     # Adam's first update against the reference's
SMALL_MOMENT = 3e-3    # |mu| below this share of the largest: the update's sign is noise
SEED = 5


def _batches(cfg):
    out = []
    T = cfg.num_frames
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        gt = np.zeros((B, T, 29), np.float32)
        gt[:, :, 28] = 1.0
        for b in range(B):
            gt[b, : 1 + b % T, 28], gt[b, : 1 + b % T, 3 + b] = 0.0, 1.0
        out.append({
            "wave": rs.randn(B, T, cfg.htsat.frontend.clip_samples).astype(np.float32),
            "image": rs.rand(B, T, 64, 64, 3).astype(np.float32),
            "gt": gt,
            "mixup_lambda": rs.beta(0.5, 0.5, size=(B * T,)).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    jcfg = tiny_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    return jcfg, pcfg, jp, js, _batches(jcfg)


def _reversed(batch):
    """The batch with its clips in reverse order (mixup's lambdas with them)."""
    r = {k: batch[k][::-1].copy() for k in ("wave", "image", "gt")}
    r["mixup_lambda"] = batch["mixup_lambda"].reshape(B, -1)[::-1].reshape(-1).copy()
    return r


@pytest.fixture(scope="module")
def jax_run(model):
    """JAX's one-device train step, two mini-steps of accum 2 without rng,
    and the first mini-step's gradient on the first batch reversed."""
    jcfg, _, jp, js, batches = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        mp.setattr(JI, "REMAT_POLICY", "full")
        tr0, fr = JT.partition_params(jax.tree_util.tree_map(jnp.asarray, jp))
        tx = JT.make_optimizer(tr0, JTrainConfig(**TRAIN_KW), steps_per_epoch=1)
        step = JT.make_train_step(jcfg, tx, donate=False)
        state0 = jax.tree_util.tree_map(jnp.asarray, js)
        tr, state, opt, run = tr0, state0, tx.init(tr0), []
        for b in batches:
            tr, state, opt, m = step(tr, fr, state, opt, b, None)
            run.append({"trainable": to_numpy(tr), "state": to_numpy(state),
                        "loss": float(m["loss"]), "acc": float(m["acc"]),
                        "acc_grads": to_numpy(opt.acc_grads),
                        "mu": to_numpy(opt.inner_opt_state[0].mu)})
        opt = step(tr0, fr, state0, tx.init(tr0), _reversed(batches[0]), None)[2]
        reordered = to_numpy(opt.acc_grads)
    return run, reordered


@pytest.fixture(scope="module")
def one_process_f64(model):
    """The port's one-process steps on the global batches in float64 with
    the draws (SEED)."""
    _, pcfg, jp, js, batches = model
    return W.to_numpy(W.ave_steps(0, 1, pcfg, jp, js, batches, TRAIN_KW, SEED, torch.float64))


def _close(got, ref, rtol, what):
    """Every leaf of `got` within rtol of the leaf's largest |ref|."""
    ref_leaves, got_leaves = dict(tree_paths(ref)), dict(tree_paths(got))
    assert set(got_leaves) == set(ref_leaves), what
    for path, r in ref_leaves.items():
        r, g = np.asarray(r, np.float64), np.asarray(got_leaves[path], np.float64)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= rtol * scale, f"{what} {path}: {err:.3e} of {scale:.3e}"


def _close_grads(got, ref):
    """Every gradient element of `got` within GRAD_TOL of its leaf's largest
    |ref| plus GRAD_FLOOR of the whole tree's largest."""
    ref_leaves = {p: np.asarray(r, np.float64) for p, r in tree_paths(ref)}
    top = max(float(np.abs(r).max()) for r in ref_leaves.values())
    for path, g in tree_paths(got):
        r = ref_leaves[path]
        err = float(np.abs(np.asarray(g, np.float64) - r).max())
        bound = GRAD_TOL * float(np.abs(r).max()) + GRAD_FLOOR * top
        assert err <= bound, f"gradient {path}: {err:.3e} > {bound:.3e}"


def _exact_grads(got, ref):
    """Float64: every gradient leaf within SELF_RTOL of its largest |ref|,
    but the leaves whose exact gradient is 0, which stay at most ZERO_SHARE
    of the tree's largest in both."""
    ref_leaves = {p: np.asarray(r, np.float64) for p, r in tree_paths(ref)}
    top = max(float(np.abs(r).max()) for r in ref_leaves.values())
    zero = {}
    for path, g in tree_paths(got):
        r, g = ref_leaves[path], np.asarray(g, np.float64)
        scale = float(np.abs(r).max())
        if scale <= ZERO_SHARE * top:
            zero[path] = (scale / top, float(np.abs(g).max()) / top)
            assert zero[path][1] <= ZERO_SHARE, f"gradient {path}: {zero[path]} of the largest"
            continue
        err = float(np.abs(g - r).max())
        assert err <= SELF_RTOL * scale, f"gradient {path}: {err:.3e} of {scale:.3e}"
    # an unused leaf reads exactly 0; any other is a bias under a normalization
    # over the batch or a softmax
    assert all(p[-1] == "bias" for p, z in zero.items() if z != (0.0, 0.0)), zero


def _update(got_after, got_before, ref_after, ref_before, mu):
    """Each trainable element's move over an applied update against the
    reference's, where |mu| is not small."""
    floor = SMALL_MOMENT * max(float(np.abs(m).max()) for _, m in tree_paths(mu))
    mus, before, ref_b, ref_a = (dict(tree_paths(t)) for t in (mu, got_before, ref_before,
                                                                   ref_after))
    counted = 0
    for path, a in tree_paths(got_after):
        keep = np.abs(mus[path]) > floor
        np.testing.assert_allclose((a - before[path])[keep], (ref_a[path] - ref_b[path])[keep],
                                   rtol=UPDATE_RTOL, atol=1e-3 * LR, err_msg=str(path))
        counted += int(keep.sum())
    assert counted > 0


def _ranks_equal(runs):
    for r in runs[1:]:
        for (p, a), (_, b) in zip(tree_paths(runs[0][-1]["trainable"]),
                                  tree_paths(r[-1]["trainable"])):
            assert np.array_equal(a, b), f"ranks differ at {p}"


def test_jax_meets_the_gradient_bound(jax_run):
    """The bound of the DP gradient against JAX's is no tighter than JAX's
    own float32 rounding: its gradient on the reordered clips meets it,
    although it moves more than GRAD_TOL of their leaf's largest in many
    leaves."""
    run, reordered = jax_run
    _close_grads(reordered, run[0]["acc_grads"])
    ref = dict(tree_paths(run[0]["acc_grads"]))
    moved = sum(float(np.abs(g - ref[p]).max()) > GRAD_TOL * float(np.abs(ref[p]).max())
                for p, g in tree_paths(reordered))
    assert moved > 0.1 * len(ref)


def test_dp_step_matches_jax(model, jax_run, tmp_path):
    jcfg, pcfg, jp, js, batches = model
    ref = jax_run[0]
    runs = W.run_world(W.ave_steps, 2, tmp_path, pcfg, jp, js, batches, TRAIN_KW, None)
    _ranks_equal(runs)
    got = runs[0]
    np.testing.assert_allclose(got[0]["loss"], ref[0]["loss"], rtol=STAT_RTOL)
    np.testing.assert_allclose(got[0]["acc"], ref[0]["acc"], rtol=STAT_RTOL)
    _close(got[0]["state"], ref[0]["state"], STAT_RTOL, "BN state")
    _close_grads(got[0]["acc_grads"], ref[0]["acc_grads"])
    jtr0 = JT.partition_params(jp)[0]
    _update(got[1]["trainable"], got[0]["trainable"], ref[1]["trainable"], jtr0, ref[1]["mu"])


def test_dp_step_matches_one_process_with_draws(model, one_process_f64, tmp_path):
    """Rule of the draws: the DP step equals one process's on the global
    batch at the same seed, SpecAugment, drop_path, dropout and mixup on;
    in float64, to rounding."""
    _, pcfg, jp, js, batches = model
    runs = W.run_world(W.ave_steps, 2, tmp_path, pcfg, jp, js, batches, TRAIN_KW, SEED,
                       torch.float64)
    one = one_process_f64
    _ranks_equal(runs)
    got = runs[0]
    for i in range(2):
        np.testing.assert_allclose(got[i]["loss"], one[i]["loss"], rtol=SELF_RTOL)
        _close(got[i]["state"], one[i]["state"], SELF_RTOL, f"BN state {i}")
    _exact_grads(got[0]["acc_grads"], one[0]["acc_grads"])
    _update(got[1]["trainable"], got[0]["trainable"], one[1]["trainable"],
            one[0]["trainable"], one[1]["mu"])


@pytest.mark.parametrize("batch", [2, 3])
def test_ave_main_smoke_in_a_world(model, tmp_path, batch):
    """`ave_main --mode smoke` as both ranks of a gloo world: a global batch
    of 2 splits over both (finite losses, the ranks' trainable leaves
    equal); one of 3 over the largest rank count that divides it, one, and
    the other rank idles (`make_data_mesh_for`)."""
    _, pcfg, _, _, _ = model
    argv = ["--mode", "smoke", "--batch-size", str(batch), "--synthetic-steps", "1"]
    runs = W.run_world(W.ave_main_smoke, 2, tmp_path, pcfg, argv, start=False)
    assert np.isfinite(runs[0]["loss"]) and 0.0 <= runs[0]["eval_acc"] <= 100.0
    if batch == 3:
        assert runs[1] is None
        return
    assert runs[0]["loss"] == runs[1]["loss"]
    for (p, a), (_, b) in zip(tree_paths(runs[0]["trainable"]),
                              tree_paths(runs[1]["trainable"])):
        assert np.array_equal(a, b), p


def test_ave_main_world_needs_the_card_unless_asked(model, monkeypatch, tmp_path):
    """A world without `--device` runs on the card, and raises without one,
    before it starts any process group."""
    _, pcfg, _, _, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PMain.main(["--mode", "smoke", "--world-size", "1", "--rank", "0", "--init-method",
                    f"file://{tmp_path}/never", "--dist-backend", "gloo"], cfg=pcfg)
    assert not torch.distributed.is_initialized()
