"""Parity of the port's pretrain and few-shot train steps with the JAX
package's, shared by tests/test_torch_pretrain_train.py and
tests/test_torch_pretrain_fewshot.py (one file a step: a JAX train step of
the tiny pretrain model takes tens of seconds to compile on the CPU).
Float32, JAX at matmul precision "highest", the same weights carried across
by `from_jax`, no generator on either side (JAX's rng=None draws no
SpecAugment).

As tests/avs_train_parity.py holds the AVS step: loss, new state and
updated params at atol 1e-4 / rtol 1e-4, the step from JAX's params,
leaving out the elements whose JAX first moment is below SMALL_MOMENT of
the leaf kind's largest (Adam's first update is -lr * sign(g), so an
element whose gradient is zero but for rounding moves by a rounding's
sign), every kind of trainable leaf still counted. The loss reads the event
scores, where 1 / (lv + la) amplifies the logits' error: the loss is held
within TOL plus the event scores' bound of tests/test_torch_pretrain.py, at
TOL on the logits, carried through the loss's gradient with respect to the
scores (the few-shot loss weighs them 500x); each trainable leaf's
gradient within GRAD_SHARE of the leaf's largest JAX gradient plus
NUDGE_FACTOR times the port's own move under NUDGE (relative) changes of
the frames and the wave. A leaf with no JAX gradient (the prompt learner's
meta_net, which the forward never reads) gets none.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.models import prompt_learner as JPL
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import pretrain_train as JT
from dg_sct_tpu_torch.models import pretrain as PP
from dg_sct_tpu_torch.train import pretrain_train as PT
from dg_sct_tpu_torch.utils.tree import tree_leaves, tree_paths, tree_unflatten
from dg_sct_tpu_torch.weights import from_jax
from test_torch_pretrain import (NAMES, event_bound, jax_forward, port_pretrain_cfg,
                                 tiny_pretrain_cfg)
from torch_port_helpers import scramble_adapters, to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_SHARE = 1e-3    # each trainable leaf's gradient, of the leaf's largest JAX gradient
NUDGE = 1e-6         # relative change of the inputs for a gradient's sensitivity
NUDGE_FACTOR = 10.0  # rounding inside the backward pass against a rounding of the inputs
SMALL_MOMENT = 3e-3  # |mu| below this share of its kind's largest: the update's sign is noise
B = 2
LR = 1e-4            # pretrain_main's and few_shot_main's --lr
ROOTS = {"adapters", "prompt_learner", "clip_adapter", "clip_adapter_text", "audio_projection",
         "logit_scale_a", "av_contrastive_fc"}


def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_model(jcfg=None, seed=2):
    """Seeded tiny weights (the port's initialiser) with nonzero adapter
    gates and BN statistics, as numpy; JAX's buffers; a seeded batch with
    one-hot clip labels."""
    jcfg = jcfg or tiny_pretrain_cfg()
    pcfg = port_pretrain_cfg(jcfg)
    pp, ps, _ = PP.init_pretrain_model(pcfg, NAMES, seed=seed, device="cpu")
    jp, js = scramble_adapters(to_numpy(pp), to_numpy(ps), seed=seed)
    buffers = JPL.build_prompt_buffers(NAMES, jp["text"]["token_embedding"], jcfg.prompt,
                                       jcfg.clip)
    rs = np.random.RandomState(seed)
    T, S = jcfg.num_frames, jcfg.clip.image_size
    n_cls = buffers["tokenized"].shape[0]
    batch = {"wave": (0.3 * rs.randn(B, T, jcfg.htsat.frontend.clip_samples)).astype(np.float32),
             "image": rs.rand(B, T, S, S, 3).astype(np.float32),
             "label": np.eye(n_cls, dtype=np.float32)[[0, n_cls - 1]]}
    return jcfg, pcfg, jp, js, buffers, batch


def jax_step(make_step, jcfg, jp, js, buffers, batch, tx, epoch=1):
    """One JAX step (`make_step(jcfg, buffers, tx)`) without rng -> {"start",
    "trainable", "state", "loss", "mu"} and the gradients (mu / (1 - b1))."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        tr, fr = JT.partition_pretrain_params(jax.tree_util.tree_map(jnp.asarray, jp))
        opt = tx.init(tr)
        step = make_step(jcfg, buffers, tx)
        start = to_numpy(tr)
        tr, state, opt, m = step(tr, fr, jax.tree_util.tree_map(jnp.asarray, js), opt,
                                 jax.tree_util.tree_map(jnp.asarray, batch), None, epoch=epoch)
        adam = next(s for s in jax.tree_util.tree_leaves(
            opt, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
        mu = to_numpy(adam.mu)
    run = {"start": start, "trainable": to_numpy(tr), "state": to_numpy(state),
           "loss": float(m["loss"]), "mu": mu}
    return run, jax.tree_util.tree_map(lambda m: m / (1.0 - 0.9), mu)


def loss_tolerance(jcfg, jp, js, buffers, batch, loss, epoch):
    """TOL's share of the JAX loss plus the event scores' bound carried
    through the port loss's gradient with respect to JAX's event scores."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        out = to_numpy(jax_forward(jcfg, buffers, True)(jp, js, batch["wave"], batch["image"])[0])
    bound, _ = event_bound(out["logits_v"], out["logits_a"], TOL["atol"], TOL["rtol"])
    t = {k: torch.from_numpy(out[k]).requires_grad_() for k in
         ("event_scores", "logits_audio_image", "logits_image_audio")}
    value = loss(t, torch.from_numpy(batch["label"]), epoch=epoch, num_frames=jcfg.num_frames)
    value.backward()
    carried = float((t["event_scores"].grad.abs().numpy() * bound).sum())
    return TOL["atol"] + TOL["rtol"] * abs(float(value)) + carried


def check_update(tr, ref):
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


def check_state(got, ref):
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(ref)[0]):
        np.testing.assert_allclose(np.asarray(a), b, err_msg=str(path), **TOL)


def nudged(batch, seed):
    rs = np.random.RandomState(seed)
    out = dict(batch)
    for k in ("image", "wave"):
        out[k] = (batch[k] * (1.0 + NUDGE * rs.randn(*batch[k].shape))).astype(np.float32)
    return out


def check_gradients(got, ref, moved):
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


def check_step(make_step, opt, grad_opt, pcfg, jp, js, batch, run, grads, loss_tol, epoch=1):
    """The port's step (`make_step(pcfg, buffers, opt, device="cpu")`) from
    JAX's params against JAX's run, the loss within `loss_tol`; then the
    gradients, read from `grad_opt` (an optimizer that accumulates over 2
    mini-steps, so its state holds the first mini-step's gradients)."""
    pp, ps, pbuf = from_jax(jp, js, pcfg, device="cpu", classnames=NAMES)
    tr, fr = PT.partition_pretrain_params(pp)
    tr = tree_unflatten(tr, [torch.from_numpy(np.array(v)) for v in tree_leaves(run["start"])])
    new_tr, state, _, m = make_step(pcfg, pbuf, opt, device="cpu")(tr, fr, ps, opt.init(tr),
                                                                    batch, epoch=epoch)
    print(f"loss {float(m['loss']):.6f} against JAX's {run['loss']:.6f}, tolerance "
          f"{loss_tol:.3e}")
    assert abs(float(m["loss"]) - run["loss"]) <= loss_tol
    check_state(state, run["state"])
    check_update(new_tr, run)
    assert not any(t.requires_grad for t in tree_leaves(fr) + tree_leaves(new_tr))
    assert torch.equal(new_tr["prompt_learner"]["meta_net"]["linear1"]["kernel"],
                       tr["prompt_learner"]["meta_net"]["linear1"]["kernel"])
    gstep = make_step(pcfg, pbuf, grad_opt, device="cpu")
    got = [gstep(tr, fr, ps, grad_opt.init(tr), b, epoch=epoch)[2]["acc"]
           for b in [batch] + [nudged(batch, seed) for seed in (1, 2)]]
    check_gradients(got[0], grads, got[1:])
