"""The pretrain losses and one pretrain train step of the port
(dg_sct_tpu_torch.train.pretrain_train) against the JAX package's on the
tiny pretrain model: plain Adam at pretrain_main's lr, float32, the bounds
of tests/pretrain_parity.py. The losses on seeded outputs at atol 1e-6 /
rtol 1e-5, their gradients with respect to the outputs too (the dynamic
loss weights carry gradient in both packages)."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dg_sct_tpu.train import few_shot_main as JFS
from dg_sct_tpu.train import pretrain_train as JT
from dg_sct_tpu_torch.train import few_shot_main as PFS
from dg_sct_tpu_torch.train import pretrain_train as PT
from dg_sct_tpu_torch.train.optim import AccumulatedAdam
from pretrain_parity import LR, check_step, few_threads, jax_step, loss_tolerance, tiny_model

L_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    yield from few_threads()


def seeded_outputs(B=3, T=2, n=4, seed=0, scale=3.0):
    rs = np.random.RandomState(seed)
    return {"event_scores": (scale * rs.randn(B * T, n)).astype(np.float32),
            "logits_audio_image": (scale * rs.randn(B, B)).astype(np.float32),
            "logits_image_audio": (scale * rs.randn(B, B)).astype(np.float32)}


LOSSES = {
    "pretrain": (JT.pretrain_loss, PT.pretrain_loss, lambda rs, B, T, n: np.eye(n)[
        rs.randint(n, size=B)]),
    "few_shot": (JFS.few_shot_loss, PFS.few_shot_loss, lambda rs, B, T, n: np.eye(n)[
        rs.randint(n, size=B)]),
    "few_shot_event": (JFS.few_shot_event_loss, PFS.few_shot_event_loss,
                       lambda rs, B, T, n: np.eye(n)[rs.randint(n, size=(B, T))]),
}


@pytest.mark.parametrize("epoch", [1, 3, 6])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, epoch):
    """Values and gradients with respect to every output; the few-shot
    weights 500 up to stage_epochs (4), 5 after."""
    jl, pl, labels = LOSSES[name]
    out = seeded_outputs(seed=epoch)
    lab = labels(np.random.RandomState(epoch), 3, 2, 4).astype(np.float32)
    kw = dict(epoch=epoch, num_frames=2)
    ref, ref_g = jax.value_and_grad(lambda o: jl(o, jnp.asarray(lab), **kw))(
        jax.tree_util.tree_map(jnp.asarray, out))
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    got = pl(t, torch.from_numpy(lab), **kw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), **L_TOL)
    for k in out:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(ref_g[k]), err_msg=k, **L_TOL)


def test_soft_cross_entropy_and_scores_match_jax():
    rs = np.random.RandomState(4)
    logits, targets = rs.randn(5, 6).astype(np.float32), rs.rand(5, 6).astype(np.float32)
    np.testing.assert_allclose(float(PT.soft_cross_entropy(torch.from_numpy(logits),
                                                           torch.from_numpy(targets))),
                               float(JT.soft_cross_entropy(logits, targets)), **L_TOL)
    scores = rs.randn(3 * 4, 5).astype(np.float32)
    gt = np.eye(6, dtype=np.float32)[rs.randint(6, size=(3, 4))]
    assert PT.weak_accuracy(scores, gt[:, 0, :5], num_frames=4) == JT.weak_accuracy(
        scores, gt[:, 0, :5], num_frames=4)
    assert PT.segment_accuracy(scores, gt) == JT.segment_accuracy(scores, gt)
    assert float(PT.zero_shot_accuracy(torch.from_numpy(scores), gt[..., :5])) == \
        pytest.approx(float(JT.zero_shot_accuracy(jnp.asarray(scores), jnp.asarray(gt[..., :5]))))
    labels = rs.randint(4, size=40)
    assert PT.few_shot_subsample(labels, 3, seed=5) == JT.few_shot_subsample(labels, 3, seed=5)


def test_pretrain_step_matches_jax():
    """One step of make_pretrain_step (plain Adam) at epoch 2 from the same
    weights: loss, new BN state, updated trainables, gradients; frozen
    leaves without requires_grad; meta_net unmoved."""
    jcfg, pcfg, jp, js, buffers, batch = tiny_model()
    run, grads = jax_step(lambda c, b, tx: JT.make_pretrain_step(c, b, tx), jcfg, jp, js,
                          buffers, batch, optax.adam(LR), epoch=2)
    tol = loss_tolerance(jcfg, jp, js, buffers, batch, PT.pretrain_loss, 2)
    check_step(PT.make_pretrain_step, PT.plain_adam(LR),
               AccumulatedAdam({"train": lambda count: LR}, every_k=2), pcfg, jp, js, batch, run,
               grads, tol, epoch=2)
