"""The data-parallel AVS-S4 and AVQA stage-2 train steps of the port (the
`group` of train.avs_train and train.avqa_train: bn0's, the adapters' and
TPAVI's BNs over the global batch, the gradients averaged, the loss the
group's mean) in 2-rank gloo worlds of spawned CPU ranks
(tests/torch_parallel_worker.py), float32, no generator, against the JAX
package's loss of the one-device step on the global batch of 4 (its
train-mode forward and loss, jitted without the gradient): within 1e-5
relative. The ranks' trainable leaves bit for bit equal after the step.
"""
import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.models import avqa as JQ
from dg_sct_tpu.models import avs as JS
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.train import avqa_train as JQT
from dg_sct_tpu.train import avs_train as JST
from dg_sct_tpu_torch.data import avqa as PD
from dg_sct_tpu_torch.models import avqa as PQ
from dg_sct_tpu_torch.models import avs as PS
from dg_sct_tpu_torch.utils.tree import tree_paths
import torch_parallel_worker as W
from avs_train_parity import make_batches as avs_batches, task_batch
from test_torch_avqa import port_avqa_cfg, scramble_avqa, tiny_avqa4_cfg
from test_torch_avs import port_avs_cfg, scramble_avs, tiny_avs_variant_cfg
from torch_port_helpers import to_numpy

LOSS_RTOL = 1e-5
TRAIN_KW = dict(accum_steps=1, lr=1e-4, lr_mlp=1e-4)


def _jax_loss(fn, *args):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        mp.setattr(JI, "REMAT_POLICY", "full")
        return float(jax.jit(fn)(*args))


def _check(runs, ref_loss):
    np.testing.assert_allclose(runs[0]["loss"], ref_loss, rtol=LOSS_RTOL)
    assert runs[0]["loss"] == runs[1]["loss"]
    for (p, a), (_, b) in zip(tree_paths(runs[0]["trainable"]),
                              tree_paths(runs[1]["trainable"])):
        assert np.array_equal(a, b), p


def test_avs_s4_dp_step_matches_jax(tmp_path):
    torch.set_num_threads(2)
    jcfg = tiny_avs_variant_cfg()
    pcfg = port_avs_cfg(jcfg)
    jp, js = scramble_avs(*(to_numpy(t) for t in PS.init_avs_model(pcfg, device="cpu")))
    halves = [task_batch(b, "s4") for b in avs_batches(jcfg)]
    batch = {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}

    def loss(p, s, b):
        out, _ = JS.forward(p, s, b["image"], b["wave"], jcfg, train=True)
        return JST.f1_iou_bce_loss(out["pred"], b["mask"], jcfg.num_frames)

    ref = _jax_loss(loss, jp, js, batch)
    _check(W.run_world(W.task_step, 2, tmp_path, "avs", pcfg, jp, js, batch, TRAIN_KW), ref)


def test_avqa_stage2_dp_step_matches_jax(tmp_path):
    torch.set_num_threads(2)
    jcfg = tiny_avqa4_cfg()
    pcfg = port_avqa_cfg(jcfg)
    jp, js = (to_numpy(t) for t in PQ.init_avqa_model(pcfg, seed=8, device="cpu"))
    jp = scramble_avqa(jp, seed=8)
    batch = PD.synthetic_batch(4, img_size=jcfg.swin.img_size, num_frames=jcfg.num_frames,
                               seed=20, sr=jcfg.htsat.frontend.clip_samples)

    def loss(p, s, b):
        out, _ = JQ.forward(p, s, b["wave"], b["visual_posi"], b["visual_nega"], b["question"],
                            jcfg, train=True)
        return JQT.avqa_loss(out, b["answer"])

    ref = _jax_loss(loss, jp, js, batch)
    _check(W.run_world(W.task_step, 2, tmp_path, "avqa", pcfg, jp, js, batch, TRAIN_KW), ref)
