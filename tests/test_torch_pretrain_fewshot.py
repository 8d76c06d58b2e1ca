"""One few-shot train step of the port (dg_sct_tpu_torch.train.few_shot_main:
make_few_shot_step with few_shot_loss, the gradients clipped by their global
norm, then Adam) against the JAX package's (`optax.chain(
clip_by_global_norm(1.0), adam(1e-4))`) on the tiny pretrain model at the
first stage (the event loss at 500x, so the global norm is far above 1 and
the clip scales every gradient): loss, new state and updated trainables
within the bounds of tests/pretrain_parity.py (the loss within the event
scores' bound carried through it), and the clipped gradients
(JAX's Adam moment holds them) against the port's."""
import optax
import pytest

from dg_sct_tpu.train import few_shot_main as JFS
from dg_sct_tpu_torch.train import few_shot_main as PFS
from dg_sct_tpu_torch.train.optim import AccumulatedAdam, ClippedAdam, clip_by_global_norm
from pretrain_parity import LR, check_step, few_threads, jax_step, loss_tolerance, tiny_model

CLIP = 1.0   # few_shot_main's --grad-clip


class ClippedAccumulated(AccumulatedAdam):
    """The clip, then Adam accumulated over 2 mini-steps: after one mini-step
    its state holds that step's clipped gradients."""

    def update(self, grads, state, params):
        return super().update(clip_by_global_norm(grads, CLIP), state, params)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    yield from few_threads()


def test_few_shot_step_matches_jax():
    jcfg, pcfg, jp, js, buffers, batch = tiny_model(seed=3)
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    run, grads = jax_step(lambda c, b, t: JFS.make_few_shot_step(c, b, t, loss=JFS.few_shot_loss),
                          jcfg, jp, js, buffers, batch, tx)
    tol = loss_tolerance(jcfg, jp, js, buffers, batch, PFS.few_shot_loss, 1)
    sched = {"train": lambda count: LR}
    check_step(lambda c, b, o, device: PFS.make_few_shot_step(c, b, o, PFS.few_shot_loss,
                                                              device=device),
               ClippedAdam(sched, CLIP), ClippedAccumulated(sched, every_k=2), pcfg, jp, js,
               batch, run, grads, tol)
