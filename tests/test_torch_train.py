"""The port's AVE training (dg_sct_tpu_torch: train-mode forward, loss,
gradients, the train step with accumulation, remat, the train-state
bundle, `ave_main`) against the JAX package on the tiny model, float32,
JAX at matmul precision "highest", the same weights carried across by
`from_jax`. JAX's train step is compiled once for the module.

Tolerances: train forward outputs and new state atol 1e-4 / rtol 1e-4;
gradients atol 1e-4 / rtol 1e-3; the 4 mini-steps of the train step:
state, loss and acc atol 1e-4 / rtol 1e-3, the params unchanged on the
first mini-step of an update, and each applied update's change of the
params, from JAX's params before it, rtol 1e-3 for the first update and
5e-2 for the second, atol 1e-3·lr. Adam's first update is ±lr wherever a
gradient is nonzero, its second the ratio of two gradients, which match
JAX's only to the gradient tolerance; where the first moment is small
against the update's largest (below 3e-3 of it), that ratio is noise and
the sign of a gradient that is zero but for rounding (LN_before's bias
feeds a training-mode BN, which removes it) decides the step, so the
update check leaves those elements out. Starting each update from JAX's
params keeps such a step out of the next update's gradients."""
import dataclasses
import io
import contextlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import TrainConfig as JTrainConfig
from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import ave_train as JT
from dg_sct_tpu.utils import checkpoint as JCk
from dg_sct_tpu_torch.configs import TrainConfig as PTrainConfig
from dg_sct_tpu_torch.configs import ave_adapter_dims
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.train import ave_main as PMain
from dg_sct_tpu_torch.train import ave_train as PT
from dg_sct_tpu_torch.train import losses
from dg_sct_tpu_torch.utils import checkpoint as PCk
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten
from dg_sct_tpu_torch.weights import from_jax
import media_tree
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=1e-4, rtol=1e-3)
B = 2
MINI_STEPS = 4
LR = 1e-3
UPDATE_RTOL = (1e-3, 5e-2)  # the first and the second applied update
SMALL_MOMENT = 3e-3  # |mu| below this share of the update's largest: its direction is noise


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine and slows these tiny
    forwards by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(cfg):
    """Two seeded batches: one clip with an event in 3 segments, one all
    event; mixup lambdas a segment."""
    out = []
    for seed in (0, 1):
        rs = np.random.RandomState(seed)
        T = cfg.num_frames
        gt = np.zeros((B, T, 29), np.float32)
        gt[:, :, 28] = 1.0
        gt[0, :1, 28], gt[0, :1, 3 + seed] = 0.0, 1.0
        gt[1, :, 28], gt[1, :, 9] = 0.0, 1.0
        out.append({
            "wave": rs.randn(B, T, cfg.htsat.frontend.clip_samples).astype(np.float32),
            "image": rs.rand(B, T, 64, 64, 3).astype(np.float32),
            "gt": gt,
            "mixup_lambda": rs.beta(0.5, 0.5, size=(B * T,)).astype(np.float32)})
    return out


def _train_cfgs():
    kw = dict(accum_steps=2, lr=LR, lr_mlp=LR, decay_epoch=1, decay=0.1)
    return JTrainConfig(**kw), PTrainConfig(**kw)


@pytest.fixture(scope="module")
def model():
    """Seeded weights (the port's initialiser; JAX's is slow on the CPU) with
    nonzero adapter gates and BN statistics, as numpy."""
    jcfg = tiny_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    return jcfg, pcfg, jp, js, _batches(jcfg)


@pytest.fixture(scope="module")
def jax_run(model):
    """JAX's train step (accum 2, StepLR decaying every applied update):
    MINI_STEPS mini-steps without rng, the batches in turns. Per mini-step:
    trainable, state, metrics, the schedule's count, the accumulated
    gradient and Adam's first moment."""
    jcfg, _, jp, js, batches = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        mp.setattr(JI, "REMAT_POLICY", "full")
        tr, fr = JT.partition_params(jax.tree_util.tree_map(jnp.asarray, jp))
        tx = JT.make_optimizer(tr, _train_cfgs()[0], steps_per_epoch=1)
        opt = tx.init(tr)
        step = JT.make_train_step(jcfg, tx, donate=False)
        state, run = jax.tree_util.tree_map(jnp.asarray, js), []
        for i in range(MINI_STEPS):
            tr, state, opt, m = step(tr, fr, state, opt, batches[i % 2], None)
            run.append({"trainable": to_numpy(tr), "state": to_numpy(state),
                        "loss": float(m["loss"]), "acc": float(m["acc"]),
                        "count": int(opt.gradient_step), "acc_grads": to_numpy(opt.acc_grads),
                        "mu": to_numpy(opt.inner_opt_state[0].mu)})
        fwd = jax.jit(lambda p, s, b: JA.forward(p, s, b["wave"], b["image"], jcfg, train=True,
                                                 mixup_lambda=b["mixup_lambda"]))
        out, new_state = fwd(jp, js, batches[0])
        eval_fwd = jax.jit(lambda p, s, b: JA.forward(p, s, b["wave"], b["image"], jcfg)[0])
        yield {"steps": run, "train_out": to_numpy(out), "train_state": to_numpy(new_state),
               "eval_fwd": eval_fwd}


def _close_trees(got, ref, **tol):
    ref_leaves = dict(tree_paths(ref))
    got_leaves = dict(tree_paths(got))
    assert set(got_leaves) == set(ref_leaves)
    for path, r in ref_leaves.items():
        g = got_leaves[path]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(path), **tol)


def _port(model):
    jcfg, pcfg, jp, js, batches = model
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    return pcfg, pp, ps, batches


def test_train_forward_matches_jax(model, jax_run):
    """Train mode, no generator, a given mixup lambda: outputs and the new
    state, every BN count included."""
    pcfg, pp, ps, batches = _port(model)
    b = batches[0]
    out, new_state = PA.forward(pp, ps, b["wave"], b["image"], pcfg, train=True, device="cpu",
                                mixup_lambda=b["mixup_lambda"])
    _close_trees(out, jax_run["train_out"], **FWD_TOL)
    _close_trees(new_state, jax_run["train_state"], **FWD_TOL)
    counts = [int(c) for p, c in tree_paths(new_state) if p[-1] == "count"]
    assert len(counts) == 1 + 2 * 4 * len(ave_adapter_dims(pcfg.swin, pcfg.htsat))
    assert set(counts) == {1}


def test_gradients_match_jax(model, jax_run):
    """The gradient of every trainable leaf on the first batch against
    jax.value_and_grad's (which MultiSteps holds after the first of 2
    mini-steps); the frozen leaves take no gradient."""
    pcfg, pp, ps, batches = _port(model)
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, _train_cfgs()[1], steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, device="cpu")
    _, _, opt_state, _ = step(tr, fr, ps, opt.init(tr), batches[0])
    _close_trees(opt_state["acc"], jax_run["steps"][0]["acc_grads"], **TOL)
    assert max(float(g.abs().max()) for g in tree_leaves(opt_state["acc"])) > 0
    assert not any(t.requires_grad or t.grad is not None for t in tree_leaves(fr))
    # the backward pass reaches no frozen weight
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tr)]
    params = PT.merge_params(tree_unflatten(tr, leaves), fr)
    out, _ = PA.forward(params, ps, batches[0]["wave"], batches[0]["image"], pcfg, train=True,
                        device="cpu")
    losses.ave_loss(out, torch.from_numpy(batches[0]["gt"])).backward()
    assert all(t.grad is None for t in tree_leaves(fr))
    assert sum(t.grad is not None for t in leaves) > 0.9 * len(leaves)


def _check_update(tr, start, ref, ref_start, rtol):
    """The port's change of every trainable element over one applied update
    against JAX's, from the same start, where JAX's first moment is not
    small (SMALL_MOMENT); checks that elements of every kind of leaf
    count."""
    mu = dict(tree_paths(ref["mu"]))
    floor = SMALL_MOMENT * max(float(np.abs(m).max()) for m in mu.values())
    got, new, old = dict(tree_paths(tr)), dict(tree_paths(ref["trainable"])), dict(ref_start)
    counted = set()
    for path, t in tree_paths(start):
        keep = np.abs(mu[path]) > floor
        delta = (got[path] - t).numpy()[keep]
        np.testing.assert_allclose(delta, (new[path] - old[path])[keep], rtol=rtol,
                                   atol=1e-3 * LR, err_msg=str(path))
        if keep.any():
            counted.add((path[0], path[-1]))
    assert {("adapters", "kernel"), ("temporal_attn", "kernel"), ("CMBS", "kernel"),
            ("adapters", "gate")} <= counted


def test_train_steps_match_jax(model, jax_run):
    """MINI_STEPS mini-steps with accum 2 against JAX's make_train_step +
    make_optimizer: state and metrics after each; nothing moves on the
    first mini-step of an update; each applied update changes the params as
    JAX's does, from JAX's params before it; the schedule counts applied
    updates and its lr decays inside the run."""
    pcfg, pp, ps, batches = _port(model)
    tr, fr = PT.partition_params(pp)
    tcfg = _train_cfgs()[1]
    opt = PT.make_optimizer(tr, tcfg, steps_per_epoch=1)
    opt_state, state = opt.init(tr), ps
    step = PT.make_train_step(pcfg, opt, device="cpu")
    start, ref_start = tr, tree_paths(PT.partition_params(model[2])[0])
    lrs = []
    for i, ref in enumerate(jax_run["steps"]):
        before = tr
        tr, state, opt_state, m = step(tr, fr, state, opt_state, batches[i % 2])
        _close_trees(state, ref["state"], **TOL)
        np.testing.assert_allclose(float(m["loss"]), ref["loss"], **TOL)
        np.testing.assert_allclose(float(m["acc"]), ref["acc"], **TOL)
        assert opt_state["gradient_step"] == ref["count"] == (i + 1) // 2
        if i % 2 == 0:
            assert all(a is b for a, b in zip(tree_leaves(tr), tree_leaves(before)))
            _close_trees(tr, ref["trainable"], **TOL)
        else:
            _check_update(tr, start, ref, ref_start, UPDATE_RTOL[i // 2])
            ref_start = tree_paths(ref["trainable"])
            tr = start = tree_unflatten(tr, [torch.from_numpy(np.array(r)) for _, r in ref_start])
        lrs.append(opt.schedules["train"](opt_state["gradient_step"]))
    np.testing.assert_allclose(lrs, [LR, LR * 0.1, LR * 0.1, LR * 0.01], rtol=1e-6)


def _grads(pcfg, pp, ps, batch, remat_policy, seed):
    gen = torch.Generator().manual_seed(seed)
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, PTrainConfig(accum_steps=2), steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, device="cpu", remat_policy=remat_policy)
    _, state, opt_state, m = step(tr, fr, ps, opt.init(tr), batch, gen)
    return opt_state["acc"], state, m


def test_remat_policies_give_equal_gradients(model):
    """drop_path at rate 0.2 / 0.1 and dropout from one seeded generator:
    remat "full" and "dots" recompute the checkpointed blocks, and their
    gradients equal those of "none"; the masks are drawn before each
    checkpointed block, so the recompute cannot draw new ones."""
    jcfg, pcfg, jp, js, batches = model
    pcfg = dataclasses.replace(pcfg, swin=dataclasses.replace(pcfg.swin, drop_path_rate=0.2),
                               htsat=dataclasses.replace(pcfg.htsat, drop_path_rate=0.1))
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    ref, ref_state, ref_m = _grads(pcfg, pp, ps, batches[0], "none", seed=3)
    other, _, other_m = _grads(pcfg, pp, ps, batches[0], "none", seed=4)
    assert float(ref_m["loss"]) != float(other_m["loss"])  # the generator matters
    for policy in ("full", "dots"):
        got, state, m = _grads(pcfg, pp, ps, batches[0], policy, seed=3)
        assert float(m["loss"]) == float(ref_m["loss"])
        for (path, g), r in zip(tree_paths(got), tree_leaves(ref)):
            torch.testing.assert_close(g, r, rtol=0, atol=0, msg=lambda s: f"{path}: {s}")
        for g, r in zip(tree_leaves(state), tree_leaves(ref_state)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("split", [2, 3])
def test_checkpoint_read_by_jax_and_resume(model, jax_run, tmp_path, split):
    """`split` mini-steps, save, load, the rest of 4 equals 4 straight, bit
    for bit, with the generator on (split 3 saves in the middle of an
    accumulation); JAX's load_params_and_state reads the bundle, and JAX's
    eval forward on it matches the port's."""
    jcfg, pcfg, _, _, batches = model
    _, pp, ps, _ = _port(model)

    def run(tr, fr, state, opt_state, gen, steps):
        for i in steps:
            tr, state, opt_state, m = step(tr, fr, state, opt_state, batches[i % 2], gen)
        return tr, state, opt_state, m

    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, PTrainConfig(accum_steps=2), steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, device="cpu")
    gen = torch.Generator().manual_seed(11)
    straight = run(tr, fr, ps, opt.init(tr), gen, range(4))

    gen = torch.Generator().manual_seed(11)
    tr2, st2, os2, _ = run(tr, fr, ps, opt.init(tr), gen, range(split))
    path = str(tmp_path / "resume.npz")
    PCk.save_train_state(path, params=PT.merge_params(tr2, fr), state=st2, opt_state=os2,
                         rng_state=gen.get_state(), step=split, metadata={"epoch": 1})
    lp, ls, lo, rng_state, n = PCk.load_train_state(path, opt_state_template=opt.init(tr))
    assert n == split and lo["mini_step"] == split % 2
    params = PCk.restore_structure(pp, lp)
    gen2 = torch.Generator().set_state(rng_state)
    resumed = run(*PT.partition_params(params), PCk.restore_structure(ps, ls), lo, gen2,
                  range(split, 4))
    for a, b in zip(tree_leaves(resumed[:3]), tree_leaves(straight[:3])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert float(resumed[3]["loss"]) == float(straight[3]["loss"])

    jp, js = JCk.load_params_and_state(path)
    ref = jax_run["eval_fwd"](jp, js, {k: batches[1][k] for k in ("wave", "image")})
    got = PA.forward(params, PCk.restore_structure(ps, ls), batches[1]["wave"],
                     batches[1]["image"], pcfg, device="cpu")
    _close_trees(got, to_numpy(ref), atol=2e-4, rtol=2e-3)


def test_ave_main_smoke_and_train_loop(model, tmp_path):
    """`--mode smoke --device cpu` on the tiny config; then `--mode train`
    over a seeded AVE tree on disk (best checkpoint with the train state,
    metrics log, run snapshot) and `--mode eval` from that checkpoint."""
    _, pcfg, _, _, _ = model
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        PMain.main(["--mode", "smoke", "--device", "cpu", "--batch-size", "2"], cfg=pcfg)
    lines = log.getvalue().splitlines()
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines if ln.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any(ln.startswith("eval correct_frac=") for ln in lines)

    root = str(tmp_path)
    cats = [f"cat{i:02d}" for i in range(28)]
    tree = media_tree.make_ave_tree(root, [f"av{i}" for i in range(4)], cats, n_frames=3,
                                    img_size=pcfg.swin.img_size, wave_samples=6400)
    save = os.path.join(root, "ckpt")
    common = ["--meta", root, "--frames", tree["frames"], "--audio", tree["audio"],
              "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        best = PMain.main(["--mode", "train", "--epochs", "1", "--batch-size", "2",
                           "--accum", "1", "--save-dir", save] + common, cfg=pcfg)
    cks = [f for f in os.listdir(save) if f.startswith("best_") and f.endswith(".npz")]
    assert cks == [f"best_{best:.2f}.npz"]
    assert os.path.exists(os.path.join(save, "ave.metrics.jsonl"))
    assert os.path.exists(os.path.join(save, "run_meta.json"))
    _, _, opt_state, _, step = PCk.load_train_state(os.path.join(save, cks[0]))
    assert step == 2 and int(opt_state["gradient_step"]) == 2
    with contextlib.redirect_stdout(io.StringIO()):
        acc = PMain.main(["--mode", "eval", "--ckpt", os.path.join(save, cks[0])] + common,
                         cfg=pcfg)
    assert acc == pytest.approx(best)
