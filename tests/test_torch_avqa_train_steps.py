"""Two steps of the port's AVQA stage-2 make_train_step against the JAX
package's, and the first step's gradients, on the tiny AVQA model (its own
file: one JAX train step takes about a minute to compile on the CPU).
Float32, JAX at matmul precision "highest", the same weights carried across
by `from_jax`, no generator on either side (JAX's `rng=None` draws no
SpecAugment, drop_path or dropout). Both sides run the negative branch,
the frozen Swin-V2 alone without gradients.

Each leaf is held as tests/avs_train_parity.py holds the AVS model's: loss,
new state and updated params at atol 1e-4 / rtol 1e-4, each step from
JAX's params, leaving out the elements whose JAX first moment is below
SMALL_MOMENT of the leaf kind's largest (Adam's first update is -lr *
sign(g), so an element whose gradient is zero but for rounding moves by a
rounding's sign); each trainable leaf's gradient within GRAD_SHARE of the
leaf's largest JAX gradient plus NUDGE_FACTOR times the port's own move
under NUDGE (relative) changes of the frames (both kinds) and the wave."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import TrainConfig as JTrainConfig
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import avqa_train as JT
from dg_sct_tpu_torch.configs import TrainConfig as PTrainConfig
from dg_sct_tpu_torch.data import avqa as PD
from dg_sct_tpu_torch.models import avqa as PA
from dg_sct_tpu_torch.train import avqa_train as PT
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten
from dg_sct_tpu_torch.weights import from_jax
from avs_train_parity import close_trees, few_threads
from test_torch_avqa import port_avqa_cfg, scramble_avqa, tiny_avqa4_cfg
from torch_port_helpers import to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_SHARE = 1e-3    # each trainable leaf's gradient, of the leaf's largest JAX gradient
NUDGE = 1e-6         # relative change of the inputs for a gradient's sensitivity
NUDGE_FACTOR = 10.0  # rounding inside the backward pass against a rounding of the inputs
SMALL_MOMENT = 3e-3  # |mu| below this share of its kind's largest: the update's sign is noise
B = 2
LR = 1e-4            # the AVQA recipe's
STEPS = 2
ROOTS = {"adapters", "fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4", "fc_fusion",
         "linear11", "linear12", "linear21", "linear22", "norm1", "norm2", "attn_a", "attn_v",
         "question_encoder", "fc_ans"}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    yield from few_threads()


def make_batches(cfg):
    return [PD.synthetic_batch(B, img_size=cfg.swin.img_size, num_frames=cfg.num_frames,
                               seed=20 + i, sr=cfg.htsat.frontend.clip_samples)
            for i in range(STEPS)]


@pytest.fixture(scope="module")
def model():
    """Seeded tiny AVQA weights (the port's initialiser) with nonzero adapter
    gates, as numpy; two batches."""
    jcfg = tiny_avqa4_cfg()
    pcfg = port_avqa_cfg(jcfg)
    jp, js = (to_numpy(t) for t in PA.init_avqa_model(pcfg, seed=8, device="cpu"))
    return jcfg, pcfg, scramble_avqa(jp, seed=8), js, make_batches(jcfg)


def train_cfgs(accum=1):
    kw = dict(accum_steps=accum, lr=LR, lr_mlp=LR)
    return JTrainConfig(**kw), PTrainConfig(**kw)


@pytest.fixture(scope="module")
def jax_run(model):
    """JAX's make_train_step (accum 1), STEPS steps without rng, each from the
    params the port's step gets. Per step: the params before it, trainable,
    state, loss and Adam's first moment; the first step's gradients (its
    moment / (1 - b1))."""
    jcfg, _, jp, js, batches = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        mp.setattr(JI, "REMAT_POLICY", "full")
        tr, fr = JT.partition_params(jax.tree_util.tree_map(jnp.asarray, jp))
        tx = JT.make_optimizer(tr, train_cfgs()[0], steps_per_epoch=1)
        opt = tx.init(tr)
        step = JT.make_train_step(jcfg, tx, donate=False)
        state, run = jax.tree_util.tree_map(jnp.asarray, js), []
        for i in range(STEPS):
            before = to_numpy(tr)
            tr, state, opt, m = step(tr, fr, state, opt, batches[i], None)
            run.append({"start": before, "trainable": to_numpy(tr), "state": to_numpy(state),
                        "loss": float(m["loss"]), "qa_acc": float(m["qa_acc"]),
                        "mu": to_numpy(opt[0].mu)})
    grads = jax.tree_util.tree_map(lambda m: m / (1.0 - 0.9), run[0]["mu"])
    return {"steps": run, "grads": grads}


def check_update(tr, ref):
    """The port's params after a step from `ref["start"]` against JAX's (TOL)
    where JAX's first moment is not small for its kind of leaf; every kind
    counts."""
    mu = dict(tree_paths(ref["mu"]))
    top = {}
    for path, m in mu.items():
        top[path[0]] = max(top.get(path[0], 0.0), float(np.abs(m).max()))
    want = dict(tree_paths(ref["trainable"]))
    counted = set()
    for path, t in tree_paths(tr):
        keep = np.abs(mu[path]) > SMALL_MOMENT * top[path[0]]
        np.testing.assert_allclose(t.numpy()[keep], want[path][keep], err_msg=str(path), **TOL)
        if keep.any():
            counted.add(path[0])
    assert counted == ROOTS


def nudged(batch, seed):
    rs = np.random.RandomState(seed)
    out = dict(batch)
    for k in ("visual_posi", "visual_nega", "wave"):
        out[k] = (batch[k] * (1.0 + NUDGE * rs.randn(*batch[k].shape))).astype(np.float32)
    return out


def check_gradients(got, ref, moved):
    """Each trainable leaf's gradient within GRAD_SHARE of the leaf's largest
    JAX gradient plus NUDGE_FACTOR times its largest move in `moved` (the
    port's gradients on nudged inputs); a leaf with no JAX gradient has none."""
    ref = dict(tree_paths(ref))
    moved = [dict(tree_paths(m)) for m in moved]
    for path, g in tree_paths(got):
        g, r = g.numpy(), np.asarray(ref[path])
        if not r.any():
            assert not g.any(), path
            continue
        move = max(float(np.abs(m[path].numpy() - g).max()) for m in moved)
        np.testing.assert_allclose(g, r, rtol=0, err_msg=str(path),
                                   atol=GRAD_SHARE * float(np.abs(r).max()) + NUDGE_FACTOR * move)


def test_train_steps_match_jax(model, jax_run):
    """Loss, accuracy, new state and params after each step, the first step's
    gradients; the frozen leaves never take requires_grad."""
    jcfg, pcfg, jp, js, batches = model
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, train_cfgs()[1], steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, device="cpu")
    opt_state, state = opt.init(tr), ps
    for i, r in enumerate(jax_run["steps"]):
        tr = tree_unflatten(tr, [torch.from_numpy(np.array(v)) for v in tree_leaves(r["start"])])
        tr, state, opt_state, m = step(tr, fr, state, opt_state, batches[i])
        np.testing.assert_allclose(float(m["loss"]), r["loss"], **TOL)
        assert float(m["qa_acc"]) == pytest.approx(r["qa_acc"])
        close_trees(state, r["state"], **TOL)
        check_update(tr, r)
    assert opt_state["gradient_step"] == STEPS
    assert not any(t.requires_grad for t in tree_leaves(fr) + tree_leaves(tr))

    acc = PT.make_optimizer(tr, train_cfgs(accum=2)[1], steps_per_epoch=1)
    acc_step = PT.make_train_step(pcfg, acc, device="cpu")
    tr0, _ = PT.partition_params(pp)
    grads = [acc_step(tr0, fr, ps, acc.init(tr0), b)[2]["acc"]
             for b in [batches[0]] + [nudged(batches[0], seed) for seed in (1, 2)]]
    check_gradients(grads[0], jax_run["grads"], grads[1:])
