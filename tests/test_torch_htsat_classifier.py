"""The standalone HTS-AT classifier with its long-clip branches
(dg_sct_tpu_torch.models.htsat.classifier_forward) against the JAX
package's on a tiny HTS-AT (target_t 64 mel frames) with JAX's weights
carried across by `weights.from_jax_tree`, float32, JAX at matmul precision
"highest". `crop_mel` and the eval positions exactly; the forwards within
atol 2e-4, rtol 2e-3 (as tests/test_golden.py). JAX's eval blocks run its
Pallas K2 in interpret mode; the port's run with kernels=True, which takes
the plain versions on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.models import htsat as JH
from dg_sct_tpu.ops import dsp as JD
from dg_sct_tpu_torch.models import htsat as PH
from dg_sct_tpu_torch.ops import dsp as PD
from dg_sct_tpu_torch.ops.basic import seeded_init
from dg_sct_tpu_torch.weights import from_jax_tree
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, to_numpy

ATOL, RTOL = 2e-4, 2e-3
OUTPUTS = ("clipwise_output", "framewise_output", "latent_output")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny HTS-AT weights with seeded bn0 statistics, carried onto
    the port's tree; a 1-s wave (T <= target_t) and a long one (T =
    1.8 target_t, three eval crops)."""
    jcfg = tiny_cfg().htsat
    pcfg = port_cfg(tiny_cfg()).htsat
    jp, js = to_numpy(JH.init_htsat(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(0)
    n = jcfg.frontend.mel_bins
    js["bn0"] = dict(js["bn0"], mean=(rs.randn(n) * 2 - 20).astype(np.float32),
                     var=(20 + 5 * rs.rand(n)).astype(np.float32))
    ref_p, ref_s = PH.init_htsat(seeded_init(0, "meta"), pcfg)
    pp = from_jax_tree(jp, ref_p, device="cpu")
    ps = from_jax_tree(js, ref_s, device="cpu")
    target = jcfg.frontend.target_t
    short = (0.1 * rs.randn(2, jcfg.frontend.clip_samples)).astype(np.float32)
    long = (0.1 * rs.randn(2, int(1.8 * target) * jcfg.frontend.hop_size)).astype(np.float32)
    return jcfg, pcfg, jp, js, pp, ps, short, long


def close(got, ref):
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("T", [50, 101, 1001, 2001])
def test_crop_mel_and_eval_positions_exact(T):
    assert PD.long_clip_eval_positions(T) == JD.long_clip_eval_positions(T)
    rs = np.random.RandomState(T)
    x = rs.randn(3, T, 8).astype(np.float32)
    crop = (T - 1) // 2
    pos = rs.randint(0, T - crop, 3)
    ref = np.asarray(JD.crop_mel(jnp.asarray(x), jnp.asarray(pos), crop))
    np.testing.assert_array_equal(PD.crop_mel(torch.from_numpy(x), torch.from_numpy(pos), crop)
                                  .numpy(), ref)


def test_crop_positions_from_the_generator():
    gen = torch.Generator().manual_seed(3)
    pos = PD.crop_positions(gen, 500, 2001, 1024, "cpu")
    assert pos.shape == (500,) and int(pos.min()) >= 0 and int(pos.max()) < 2001 - 1024
    again = PD.crop_positions(torch.Generator().manual_seed(3), 500, 2001, 1024, "cpu")
    assert torch.equal(pos, again)


@pytest.mark.parametrize("kernels", [False, True])
def test_short_clip_branch(tiny, kernels):
    """T <= target_t: frontend, tower and tscam head once."""
    jcfg, pcfg, jp, js, pp, ps, short, _ = tiny
    ref, _ = JH.classifier_forward(jp, js, short, jcfg, train=False)
    got, state = PH.classifier_forward(pp, ps, torch.from_numpy(short), pcfg, kernels=kernels)
    close(got, ref)
    assert state["bn0"] is ps["bn0"]


@pytest.mark.parametrize("kernels", [False, True])
def test_eval_long_clip_branch(tiny, kernels):
    """Sliding crops of (T - 1) // 2 frames, outputs averaged."""
    jcfg, pcfg, jp, js, pp, ps, _, long = tiny
    mel, _ = JH.mel_features(jp, js, long, jcfg, train=False)
    T = mel.shape[1]
    assert T > jcfg.frontend.target_t and len(JD.long_clip_eval_positions(T)[0]) >= 2
    ref, _ = JH.classifier_forward(jp, js, long, jcfg, train=False)
    got, _ = PH.classifier_forward(pp, ps, torch.from_numpy(long), pcfg, kernels=kernels)
    close(got, ref)


def test_train_long_clip_branch_on_jax_positions(tiny, monkeypatch):
    """One crop to target_t a clip at JAX's drawn positions, bn0 on the
    batch's statistics; SpecAugment off on both sides (its draws differ)."""
    jcfg, pcfg, jp, js, pp, ps, _, long = tiny
    monkeypatch.setattr(JH.dsp, "spec_augment", lambda rng, x, cfg: x)
    key = jax.random.PRNGKey(5)
    ref, ref_state = JH.classifier_forward(jp, js, long, jcfg, train=True, rng=key)
    T = JH.mel_features(jp, js, long, jcfg, train=False)[0].shape[1]
    target = jcfg.frontend.target_t
    pos = np.array(jax.random.randint(jax.random.split(key, 2)[1], (2,), 0, T - target))
    got, state = PH.classifier_forward(pp, ps, torch.from_numpy(long), pcfg, train=True,
                                       positions=torch.from_numpy(pos))
    close(got, ref)
    for k in ("mean", "var"):
        np.testing.assert_allclose(state["bn0"][k].numpy(), np.asarray(ref_state["bn0"][k]),
                                   atol=1e-5, rtol=1e-5)
    assert int(state["bn0"]["count"]) == int(ref_state["bn0"]["count"]) == 1


def test_train_draws_from_the_generator(tiny):
    """Without positions the crop (and SpecAugment) draw from `gen`: the
    same seed gives the same outputs, the plain tower runs."""
    jcfg, pcfg, jp, js, pp, ps, _, long = tiny
    run = lambda seed: PH.classifier_forward(pp, ps, torch.from_numpy(long), pcfg, train=True,
                                             gen=torch.Generator().manual_seed(seed))[0]
    a, b = run(1), run(1)
    assert all(torch.equal(a[k], b[k]) for k in OUTPUTS)
    assert a["clipwise_output"].shape == (2, pcfg.num_classes)
    with pytest.raises(ValueError, match="positions or a generator"):
        PH.classifier_forward(pp, ps, torch.from_numpy(long), pcfg, train=True)


def test_eval_refuses_clips_beyond_two_targets(tiny):
    jcfg, pcfg, jp, js, pp, ps, _, _ = tiny
    too_long = torch.zeros(1, (2 * jcfg.frontend.target_t + 8) * jcfg.frontend.hop_size)
    with pytest.raises(ValueError, match="2 \\* target_t"):
        PH.classifier_forward(pp, ps, too_long, pcfg)
