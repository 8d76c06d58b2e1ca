"""The port's tiny AVE eval forward (dg_sct_tpu_torch) against the JAX
package: weights carried across by `weights.from_jax`, the same numpy
inputs, float32 with JAX at matmul precision "highest". Whole-model
tolerance: atol 2e-4, rtol 2e-3 (as tests/test_golden.py). Also the port's
rules: no JAX import, the card by default, eval only."""
import ast
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from dg_sct_tpu.models import adapter as JAd
from dg_sct_tpu.models import ave as JA
from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.ops import windows as JW
from dg_sct_tpu.ops.pallas import block_attention as JK2
from dg_sct_tpu.ops.pallas import window_attention as JK1
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.serve import AVEInferenceEngine
from dg_sct_tpu_torch.weights import from_jax
from test_ave_model import tiny_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

ATOL, RTOL = 2e-4, 2e-3
REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "tiny_ave.npz"


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_cfg()
    jp, js = JA.init_ave_model(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(0)
    wave = rs.randn(2, jcfg.num_frames, jcfg.htsat.frontend.clip_samples).astype(np.float32)
    imgs = rs.rand(2, jcfg.num_frames, 64, 64, 3).astype(np.float32)
    return jcfg, port_cfg(jcfg), to_numpy(jp), to_numpy(js), wave, imgs


@pytest.fixture(scope="module")
def scrambled(tiny):
    """Nonzero gates and BN statistics (zero-gated adapters would not show)."""
    jcfg, pcfg, jp, js, wave, imgs = tiny
    jp, js = scramble_adapters(jax.tree_util.tree_map(np.copy, jp),
                               jax.tree_util.tree_map(np.copy, js))
    fwd = jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg, train=False)[0])
    ref = to_numpy(fwd(jp, js, wave, imgs))
    return jp, js, ref


def close_outputs(got, ref, keys=None):
    for k in keys or ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("kernels", [False, True])
def test_golden_tiny_ave(tiny, kernels):
    """from_jax(init_ave_model(PRNGKey(0))) reproduces tests/golden/tiny_ave.npz."""
    jcfg, pcfg, jp, js, wave, imgs = tiny
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    got = PA.forward(pp, ps, wave, imgs, pcfg, kernels=kernels, device="cpu")
    with np.load(GOLDEN) as z:
        close_outputs(got, {k: z[k] for k in z.files})


@pytest.mark.parametrize("kernels", [False, True])
def test_matches_jax_forward(tiny, scrambled, kernels):
    jcfg, pcfg, _, _, wave, imgs = tiny
    jp, js, ref = scrambled
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    close_outputs(PA.forward(pp, ps, wave, imgs, pcfg, kernels=kernels, device="cpu"), ref)


def _interpreted(kernel):
    """The Pallas kernel in interpret mode, whatever its caller passes."""
    return lambda *args, **kw: kernel(*args, **{**kw, "interpret": True})


def test_matches_jax_with_its_three_kernels(tiny, scrambled):
    """JAX with all three Pallas flags on (interpret mode), on folded
    adapters, against the port with kernels on (plain versions on the CPU)
    and off."""
    jcfg, pcfg, _, _, wave, imgs = tiny
    jp, js, _ = scrambled
    jfp, jfs = JI.fold_adapters_eval(jp, js, jcfg)
    orig = JK1.fused_window_attention, JK2.fused_attn_half_block
    try:
        JW.set_pallas(True)
        JW.set_fused_block(True)
        JAd.set_fused_bottleneck(True)
        JK1.fused_window_attention = _interpreted(orig[0])
        JK2.fused_attn_half_block = _interpreted(orig[1])
        fwd = jax.jit(lambda p, s, w, i: JA.forward(p, s, w, i, jcfg, train=False)[0])
        ref = to_numpy(fwd(to_numpy(jfp), to_numpy(jfs), wave, imgs))
    finally:
        JW.set_pallas(False)
        JW.set_fused_block(False)
        JAd.set_fused_bottleneck(False)
        JK1.fused_window_attention, JK2.fused_attn_half_block = orig
    from dg_sct_tpu_torch.models.interleave import fold_adapters_eval
    pp, ps = fold_adapters_eval(*from_jax(jp, js, pcfg, device="cpu"), pcfg)
    for kernels in (True, False):
        close_outputs(PA.forward(pp, ps, wave, imgs, pcfg, kernels=kernels, device="cpu"), ref)


def test_engine_fold_eval_equals_unfolded_forward(tiny, scrambled):
    """The engine on the CPU in float32: folded adapters, K3's plain
    version, uint8 frames and int16 wave dequantized on the device, a ragged
    last batch; against the unfolded plain forward on the same values."""
    jcfg, pcfg, _, _, wave, imgs = tiny
    jp, js, _ = scrambled
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    rs = np.random.RandomState(1)
    frames = rs.randint(0, 256, (3,) + imgs.shape[1:], dtype=np.uint8)
    pcm = (np.clip(rs.randn(3, *wave.shape[1:]) * 0.3, -1, 1) * 32767).astype(np.int16)
    eng = AVEInferenceEngine(pcfg, pp, ps, batch_size=2, device="cpu",
                             compute_dtype=torch.float32, gelu="exact")
    got = eng.predict(pcm, frames)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32) * 255.0
    std = np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0
    ref = PA.forward(pp, ps, torch.from_numpy(pcm).float() * (1.0 / 32767.0),
                     (frames.astype(np.float32) - mean) / std, pcfg, kernels=False,
                     device="cpu")
    close_outputs(got, ref, keys=("event_scores", "is_event_scores"))
    n_cls = got["event_scores"].shape[-1]
    pos = 1.0 / (1.0 + np.exp(-got["is_event_scores"])) > 0.5
    np.testing.assert_array_equal(
        got["segment_preds"], np.where(pos, got["event_scores"].argmax(-1)[:, None], n_cls))


def test_from_jax_checks_every_leaf(tiny):
    jcfg, pcfg, jp, js, _, _ = tiny
    extra = dict(jp, unused={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        from_jax(extra, js, pcfg, device="cpu")
    missing = dict(jp)
    missing.pop("CMBS")
    with pytest.raises(ValueError, match="missing"):
        from_jax(missing, js, pcfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, jp)
    bad["swin"]["norm"] = dict(bad["swin"]["norm"], scale=np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="shape"):
        from_jax(bad, js, pcfg, device="cpu")


def test_entry_points_need_the_card_unless_asked(tiny, monkeypatch):
    jcfg, pcfg, jp, js, wave, imgs = tiny
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PA.init_ave_model(pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AVEInferenceEngine(pcfg, pp, ps, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PA.forward(pp, ps, wave, imgs, pcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(jp, js, pcfg)
    p2, _ = PA.init_ave_model(pcfg, device="cpu")
    assert p2["swin"]["norm"]["scale"].device.type == "cpu"


def test_train_is_not_ported(tiny, monkeypatch):
    """No kernel is ported for training, as the JAX package trains through
    none: train=True never reaches a kernel wrapper, whatever `kernels`
    says, and returns (outputs, new state)."""
    from dg_sct_tpu_torch.models import adapter as PAd
    from dg_sct_tpu_torch.ops import windows as PW

    jcfg, pcfg, jp, js, wave, imgs = tiny
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    ref, ref_state = PA.forward(pp, ps, wave, imgs, pcfg, train=True, kernels=False,
                                device="cpu")

    def no_kernel(*args, **kw):
        raise AssertionError("a kernel wrapper was called in training")

    for mod, name in ((PW, "window_attention"), (PW, "fused_attn_half_block"),
                      (PAd, "fused_bottleneck")):
        monkeypatch.setattr(mod, name, no_kernel)
    got, state = PA.forward(pp, ps, wave, imgs, pcfg, train=True, kernels=True, device="cpu")
    close_outputs({k: v.detach() for k, v in got.items()},
                  {k: v.detach() for k, v in ref.items()})
    assert int(state["htsat"]["bn0"]["count"]) == 1


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "dg_sct_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "dg_sct_tpu")]
    assert not bad, bad
