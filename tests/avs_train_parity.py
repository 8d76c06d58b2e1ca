"""Parity of the port's AVS train step with the JAX package's
`make_train_step` on the tiny AVS model, shared by
tests/test_torch_avs_train_s4.py and tests/test_torch_avs_train_ms3.py (one
file a task: one JAX train step takes about a minute to compile on the
CPU), and the seeded model and batches of tests/test_torch_avs_train.py.
Float32, JAX at matmul precision "highest", the same weights carried
across by `from_jax`.

Two train steps (accum 1, Adam at the AVS recipe's lr) against JAX's at
atol 1e-4 / rtol 1e-4 for loss, new state and updated params. Adam's first
update is -lr * sign(g) wherever |g| is well above its eps, so an element
whose gradient is zero but for rounding moves by a rounding's sign:
TPAVI's W_z bias feeds a BN on the batch's statistics, which removes it,
so its exact gradient is 0. The update check leaves out the elements whose
JAX first moment is below SMALL_MOMENT of the largest, checks that every
kind of leaf still counts, and starts each step from JAX's params.

The gradient of each trainable leaf is held within 1e-3 of the leaf's
largest JAX gradient plus NUDGE_FACTOR times the port's own move under
NUDGE (relative) changes of the frames and the wave. Float32 rounding alone
puts the JAX package further from the exact gradient than 1e-4 of some
leaves' largest: against the port in float64, JAX's float32 gradients of
the tiny model are off by up to 3.2e-4 of the leaf's largest (TPAVI's
stage-0 W_z and g, where the port's are off by 8e-6, and the adapters'
aff_* linears, where the port's are off by as much as JAX's), and by
1.6e-2 for the visual adapters' gates, whose gradient sums the adapter's
output over every token and mostly cancels (the port's by 1.4e-2). The
nudge reads that conditioning leaf by leaf: a rounding of the inputs moves
the gradient by about what a rounding inside the backward pass does. A
fault in the backward pass moves a leaf by far more. The cancelled W_z
bias is held within 1e-4 of the largest gradient of all; the head's
decoders, which the forward never reads, get zero."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import TrainConfig as JTrainConfig
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import avs_train as JT
from dg_sct_tpu_torch.configs import TrainConfig as PTrainConfig
from dg_sct_tpu_torch.models import avs as PAvs
from dg_sct_tpu_torch.train import avs_train as PT
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten
from dg_sct_tpu_torch.weights import from_jax
from test_torch_avs import port_avs_cfg, scramble_avs, tiny_avs_variant_cfg
from torch_port_helpers import to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_SHARE = 1e-3    # each trainable leaf's gradient, of the leaf's largest JAX gradient
CANCELLED_SHARE = 1e-4  # a leaf whose exact gradient is 0, of the largest gradient of all
NUDGE = 1e-6         # relative change of the inputs for a gradient's sensitivity
NUDGE_FACTOR = 10.0  # rounding inside the backward pass against a rounding of the inputs
SMALL_MOMENT = 3e-3  # |mu| below this share of the largest: the update's sign is noise
B = 2
LR = 3e-4            # the AVS recipe's
STEPS = 2


def few_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine and slows these tiny
    forwards by an order of magnitude. A generator for a module fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_batches(cfg):
    """Two seeded batches of B clips with every frame's mask (B, T, S, S, 1);
    `task_batch` cuts the mask to a task's layout."""
    out = []
    for seed in (0, 1):
        rs = np.random.RandomState(10 + seed)
        T, S = cfg.num_frames, cfg.mask_size
        yy, xx = np.mgrid[:S, :S] / S
        cy, cx, r = rs.rand(B, T, 1, 1) * 0.6 + 0.2, rs.rand(B, T, 1, 1) * 0.6 + 0.2, 0.25
        masks = ((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2).astype(np.float32)[..., None]
        out.append({"image": rs.rand(B, T, S, S, 3).astype(np.float32),
                    "wave": (0.3 * rs.randn(B, T, cfg.htsat.frontend.clip_samples)).astype(
                        np.float32),
                    "masks": masks})
    return out


def task_batch(batch, task):
    m = batch["masks"]
    mask = m[:, 0] if task == "s4" else m.reshape((-1,) + m.shape[2:])
    return {"image": batch["image"], "wave": batch["wave"], "mask": mask}


def make_model():
    """Seeded tiny AVS weights (the port's initialiser; JAX's is slow on the
    CPU) with nonzero adapter gates and TPAVI BN, as numpy; two batches."""
    jcfg = tiny_avs_variant_cfg()
    pcfg = port_avs_cfg(jcfg)
    jp, js = scramble_avs(*(to_numpy(t) for t in PAvs.init_avs_model(pcfg, device="cpu")))
    return jcfg, pcfg, jp, js, make_batches(jcfg)


def train_cfgs(accum=1):
    kw = dict(accum_steps=accum, lr=LR, lr_mlp=LR)
    return JTrainConfig(**kw), PTrainConfig(**kw)


def jax_steps(model, task):
    """JAX's make_train_step (accum 1) for `task`, STEPS steps without rng,
    each from the same params the port's step gets (see the module's
    docstring). Per step: the params before it, trainable, state, loss and
    Adam's first moment; the first step's gradients (its moment / (1 - b1))."""
    jcfg, _, jp, js, batches = model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        mp.setattr(JI, "REMAT_POLICY", "full")
        tr, fr = JT.partition_params(jax.tree_util.tree_map(jnp.asarray, jp))
        tx = JT.make_optimizer(tr, train_cfgs()[0], steps_per_epoch=1)
        opt = tx.init(tr)
        step = JT.make_train_step(jcfg, tx, task=task, donate=False)
        state, run = jax.tree_util.tree_map(jnp.asarray, js), []
        for i in range(STEPS):
            before = to_numpy(tr)
            tr, state, opt, m = step(tr, fr, state, opt, task_batch(batches[i], task), None)
            run.append({"start": before, "trainable": to_numpy(tr), "state": to_numpy(state),
                        "loss": float(m["loss"]), "mu": to_numpy(opt[0].mu)})
    grads = jax.tree_util.tree_map(lambda m: m / (1.0 - 0.9), run[0]["mu"])
    return {"steps": run, "grads": grads}


def port(model):
    jcfg, pcfg, jp, js, batches = model
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    return pcfg, pp, ps, batches


def close_trees(got, ref, **tol):
    ref_leaves, got_leaves = dict(tree_paths(ref)), dict(tree_paths(got))
    assert set(got_leaves) == set(ref_leaves)
    for path, r in ref_leaves.items():
        g = got_leaves[path]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(r), err_msg=str(path), **tol)


def cancelled(path) -> bool:
    """TPAVI's W_z bias: a per-channel shift in front of a BN on the batch's
    statistics, which removes it, so its exact gradient is 0."""
    return path[0] == "tpavi" and path[2] == "W_z" and path[-1] == "bias"


def check_gradients(got, ref, moved):
    """Each trainable leaf's gradient within GRAD_SHARE of the leaf's largest
    JAX gradient plus NUDGE_FACTOR times its largest move in `moved` (the
    port's gradients on nudged inputs); the cancelled leaves within
    CANCELLED_SHARE of the largest gradient of all; the unused ones (the
    head's decoders) zero."""
    ref = dict(tree_paths(ref))
    moved = [dict(tree_paths(m)) for m in moved]
    top = max(float(np.abs(r).max()) for r in ref.values())
    assert top > 0
    unused = 0
    for path, g in tree_paths(got):
        g, r = g.numpy(), np.asarray(ref[path])
        if cancelled(path):
            assert np.abs(g).max() <= CANCELLED_SHARE * top, path
            continue
        if not r.any():
            assert not g.any(), path
            unused += path[0] == "temporal_attn" and "decoder" in path[3]
            continue
        move = max(float(np.abs(m[path].numpy() - g).max()) for m in moved)
        np.testing.assert_allclose(g, r, rtol=0, err_msg=str(path),
                                   atol=GRAD_SHARE * float(np.abs(r).max()) + NUDGE_FACTOR * move)
    assert unused > 0


def nudged(batch, seed):
    rs = np.random.RandomState(seed)
    out = dict(batch)
    for k in ("image", "wave"):
        out[k] = (batch[k] * (1.0 + NUDGE * rs.randn(*batch[k].shape))).astype(np.float32)
    return out


def check_update(tr, ref):
    """The port's params after a step from `ref["start"]` against JAX's
    (TOL), where JAX's first moment is not small; every kind of leaf
    counts."""
    mu = dict(tree_paths(ref["mu"]))
    floor = SMALL_MOMENT * max(float(np.abs(m).max()) for m in mu.values())
    want = dict(tree_paths(ref["trainable"]))
    counted = set()
    for path, t in tree_paths(tr):
        keep = np.abs(mu[path]) > floor
        np.testing.assert_allclose(t.numpy()[keep], want[path][keep], err_msg=str(path), **TOL)
        if keep.any():
            counted.add(path[0])
    assert counted == {"adapters", "scale_linears", "audio_linear", "temporal_attn", "tpavi",
                       "paths", "out_conv1", "out_conv2", "out_conv3"}


def port_steps_match_jax(model, ref, task):
    """STEPS steps of the port's make_train_step against JAX's `ref`
    (`jax_steps`), each from JAX's params before it: loss, state and params;
    the first step's gradients (accum 2: the port's accumulated gradient
    after one mini-step)."""
    pcfg, pp, ps, batches = port(model)
    tr, fr = PT.partition_params(pp)
    opt = PT.make_optimizer(tr, train_cfgs()[1], steps_per_epoch=1)
    step = PT.make_train_step(pcfg, opt, task=task, device="cpu")
    opt_state, state = opt.init(tr), ps
    for i, r in enumerate(ref["steps"]):
        tr = tree_unflatten(tr, [torch.from_numpy(np.array(v))
                                 for v in tree_leaves(r["start"])])
        tr, state, opt_state, m = step(tr, fr, state, opt_state,
                                       task_batch(batches[i], task))
        np.testing.assert_allclose(float(m["loss"]), r["loss"], **TOL)
        close_trees(state, r["state"], **TOL)
        check_update(tr, r)
    assert opt_state["gradient_step"] == STEPS
    assert not any(t.requires_grad for t in tree_leaves(fr) + tree_leaves(tr))

    acc = PT.make_optimizer(tr, train_cfgs(accum=2)[1], steps_per_epoch=1)
    acc_step = PT.make_train_step(pcfg, acc, task=task, device="cpu")
    tr0, _ = PT.partition_params(pp)
    grads = [acc_step(tr0, fr, ps, acc.init(tr0), b)[2]["acc"]
             for b in [task_batch(batches[0], task)]
             + [nudged(task_batch(batches[0], task), seed) for seed in (1, 2)]]
    check_gradients(grads[0], ref["grads"], grads[1:])
