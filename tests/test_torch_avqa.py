"""The port's AVQA model (dg_sct_tpu_torch: configs.AVQAModelConfig,
ops.rnn.lstm_with_state, the standalone towers swinv2.forward_features and
htsat.forward_features, models.avqa, models.avqa_grounding,
ops.quant.calibrate_avqa, weights.from_jax) against the JAX package on the
same numpy inputs and weights, float32 with JAX at matmul precision
"highest", kernels off or on CPU tensors (their plain versions).

The tiny configuration is the JAX package's `tiny_avqa_cfg` with AVQA's
four channel groups in every adapter (AVQAModelConfig() has four; the JAX
test keeps two), so K3's plain version runs at four groups; the adapters'
gates are set nonzero from a seed.

Tolerances: the LSTM, the question encoder and the grounding at atol 1e-5 /
rtol 1e-4 (a few float32 sums); the standalone towers, the grounding
forward and the whole tiny AVQA forward (all three outputs) at atol 2e-4 /
rtol 2e-3, as tests/test_torch_avs.py holds the AVS model; `out_qa` without
the negative branch bit-identical to `out_qa` with it; DG-SCT's own AVQA
modules through the goldens (tests/golden/refgold_avqa_*) at
tests/test_reference_golden.py's tolerances; the calibration scales at rtol
1e-4; the int8 forward within half of JAX's int8-against-float drift (as
tests/test_torch_quant.py)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu import configs as JC
from dg_sct_tpu.models import avqa as JA
from dg_sct_tpu.models import avqa_grounding as JG
from dg_sct_tpu.models import htsat as JH
from dg_sct_tpu.models import swinv2 as JS
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import quant as JQ
from dg_sct_tpu.ops import rnn as JR
import dg_sct_tpu_torch.configs as PC
from dg_sct_tpu_torch.models import adapter as PAd
from dg_sct_tpu_torch.models import avqa as PA
from dg_sct_tpu_torch.models import avqa_grounding as PG
from dg_sct_tpu_torch.models import htsat as PH
from dg_sct_tpu_torch.models import swinv2 as PS
from dg_sct_tpu_torch.ops import quant as PQ
from dg_sct_tpu_torch.ops import rnn as PR
from dg_sct_tpu_torch.ops.basic import Init
from dg_sct_tpu_torch.utils import torch_convert as PTC
from dg_sct_tpu_torch.weights import from_jax
from gen_reference_goldens import ADAPTER_SPECS
from refgold_common import load_census, outputs_path, rebuild_sd, synth, synth_tokens
from test_avqa_model import tiny_avqa_cfg
from test_torch_avs import _fields, _shapes, close
from torch_port_helpers import to_numpy, to_torch

S_ATOL, S_RTOL = 1e-5, 1e-4      # the LSTM, the question encoder, the grounding
MIN_DIM = 16                     # int8 at tiny widths, as tests/test_torch_quant.py
DRIFT_SHARE = 0.5                # int8: port against JAX, as a share of JAX's int8 drift
AVQA_FIELDS = ("num_frames", "embed_dim", "qst_vocab_size", "ans_vocab_size", "max_qst_len")
OUTPUTS = ("out_qa", "out_match_posi", "out_match_nega")


def port_avqa_cfg(jcfg):
    """The port's AVQAModelConfig with every field of the JAX one."""
    h = jcfg.htsat
    frontend = PC.AudioFrontendConfig(**_fields(h.frontend, stft_compute=None))
    return PC.AVQAModelConfig(
        swin=PC.SwinV2Config(**_fields(jcfg.swin)),
        htsat=PC.HTSATConfig(**_fields(h, frontend=frontend)),
        adapter=PC.AdapterConfig(**_fields(jcfg.adapter)),
        adapter_vis=PC.AdapterConfig(**_fields(jcfg.adapter_vis)),
        **{k: getattr(jcfg, k) for k in AVQA_FIELDS})


def tiny_avqa4_cfg():
    """`tiny_avqa_cfg` with four channel groups in both adapter kinds."""
    j = tiny_avqa_cfg()
    four = lambda a: dataclasses.replace(a, num_conv_group=4)
    return dataclasses.replace(j, adapter=four(j.adapter), adapter_vis=four(j.adapter_vis))


def scramble_avqa(params, seed=0):
    """Seeded nonzero gate_av in every adapter and gate in the visual ones of
    a numpy AVQA tree: zero at init, they would hide the adapters."""
    rs = np.random.RandomState(seed)
    for k in ("a_p1", "v_p1", "a_p2", "v_p2"):
        for ap in params["adapters"][k]:
            for g in ("gate", "gate_av"):
                if g in ap:
                    ap[g] = np.asarray([0.3 + 0.3 * rs.rand()], np.float32)
    return params


def tiny_inputs(cfg, B=2, seed=1):
    """(wave, visual_posi, visual_nega, question) of B seeded clips; the
    question holds padding (0) at its end."""
    rs = np.random.RandomState(seed)
    T, S = cfg.num_frames, cfg.swin.img_size
    q = rs.randint(1, cfg.qst_vocab_size, size=(B, cfg.max_qst_len))
    q[:, 9:] = 0
    return ((0.3 * rs.randn(B, T, cfg.htsat.frontend.clip_samples)).astype(np.float32),
            rs.rand(B, T, S, S, 3).astype(np.float32), rs.rand(B, T, S, S, 3).astype(np.float32),
            q)


def jax_forward(jcfg):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")  # the parity form, whatever ran before
        return jax.jit(lambda p, s, w, a, b, q: JA.forward(p, s, w, a, b, q, jcfg)[0])


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Parallel test workers share the cores; a full set of intra-op threads
    in each of them oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """Seeded tiny AVQA weights (the port's initialiser) with nonzero adapter
    gates, as numpy for JAX and carried across by from_jax; seeded inputs;
    JAX's forward, run once."""
    jcfg = tiny_avqa4_cfg()
    pcfg = port_avqa_cfg(jcfg)
    jp, js = (to_numpy(t) for t in PA.init_avqa_model(pcfg, device="cpu"))
    jp = scramble_avqa(jp)
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    wave, posi, nega, q = tiny_inputs(jcfg)
    fwd = jax_forward(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax.tree_util.tree_map(np.asarray, fwd(jp, js, wave, posi, nega, q))
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, js=js, pp=pp, ps=ps, wave=wave, posi=posi,
                nega=nega, q=q, ref=ref, fwd=fwd)


def _port_forward(t, params=None, nega="nega", **kw):
    with torch.inference_mode():
        return PA.forward(t["pp"] if params is None else params, t["ps"], t["wave"], t["posi"],
                          None if nega is None else t[nega], t["q"], t["pcfg"], device="cpu",
                          **{"kernels": False, **kw})


def test_config_matches_jax():
    j, p = JC.AVQAModelConfig(), PC.AVQAModelConfig()
    skip = ("compute_dtype", "swin", "htsat", "adapter", "adapter_vis")
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(p)]
    assert {k: v for k, v in _fields(j).items() if k not in skip} == {
        k: v for k, v in _fields(p).items() if k not in skip}
    for name in ("swin", "htsat", "adapter", "adapter_vis"):
        jf, pf = _fields(getattr(j, name)), _fields(getattr(p, name))
        jf.pop("frontend", None), pf.pop("frontend", None)
        assert jf == pf, name
    assert p.compute_dtype == torch.float32
    assert (p.adapter.num_conv_group, p.adapter.num_tokens, p.adapter.use_gate,
            p.adapter_vis.use_gate, p.adapter.use_bn) == (4, 2, False, True, False)
    assert PC.vis_adapter_cfg(p) is p.adapter_vis


@pytest.mark.parametrize("which", ["fusion", "grounding"])
def test_init_trees_match_jax_at_full_width(which):
    """The stage-2 and the stage-1 model's trees and shapes on "meta" equal
    JAX's (eval_shape)."""
    init_j = JA.init_avqa_model if which == "fusion" else JG.init_grounding_model
    init_p = PA.init_avqa_model if which == "fusion" else PG.init_grounding_model
    pp, ps = init_p(PC.AVQAModelConfig(), device="meta")
    jp, js = jax.eval_shape(lambda k: init_j(k, JC.AVQAModelConfig()), jax.random.PRNGKey(0))
    assert _shapes(pp) == _shapes(jp)
    assert _shapes(ps) == _shapes(js)


# ---------------------------------------------------------------------------
# the question encoder and the grounding
# ---------------------------------------------------------------------------

def _params(make, seed):
    """A port init (`make(Init)`) as a numpy tree for JAX and CPU tensors for
    the port."""
    tree = to_numpy(make(Init(torch.Generator().manual_seed(seed), "cpu")))
    return tree, to_torch(tree)


def test_lstm_with_state_matches_jax():
    jp, pp = _params(lambda i: PR.lstm_cell_init(i, 12, 10), 0)
    x = np.random.RandomState(0).randn(3, 7, 12).astype(np.float32)
    ref_o, (ref_h, ref_c) = JR.lstm_with_state(jp, jnp.asarray(x))
    got_o, (got_h, got_c) = PR.lstm_with_state(pp, torch.from_numpy(x))
    close(got_o, ref_o, S_ATOL, S_RTOL)
    close(got_h, ref_h, S_ATOL, S_RTOL)
    close(got_c, ref_c, S_ATOL, S_RTOL)
    close(PR.lstm(pp, torch.from_numpy(x)), JR.lstm(jp, jnp.asarray(x)), S_ATOL, S_RTOL)
    assert not np.allclose(got_c.numpy(), got_h.numpy())


def test_qst_encoder_matches_jax():
    jp, pp = _params(lambda i: PA.init_qst_encoder(i, 93, 24, 24, 24), 1)
    assert _shapes(jp) == _shapes(JA.init_qst_encoder(jax.random.PRNGKey(0), 93, 24, 24, 24))
    q = np.random.RandomState(1).randint(0, 93, size=(3, 14))
    close(PA.qst_encoder(pp, torch.from_numpy(q)), JA.qst_encoder(jp, jnp.asarray(q)),
          S_ATOL, S_RTOL)


def test_grounding_matches_jax():
    cfg = port_avqa_cfg(tiny_avqa4_cfg())
    jp, pp = _params(lambda i: PA.init_grounding_heads(i, cfg), 2)
    rs = np.random.RandomState(2)
    d = cfg.embed_dim
    audio, tokens = rs.randn(6, d).astype(np.float32), rs.randn(6, 9, d).astype(np.float32)
    ref = JA._grounding(jp, jnp.asarray(audio), jnp.asarray(tokens))
    got = PA._grounding(pp, torch.from_numpy(audio), torch.from_numpy(tokens))
    close(got[0], ref[0], S_ATOL, S_RTOL)
    close(got[1], ref[1], S_ATOL, S_RTOL)


# ---------------------------------------------------------------------------
# the standalone towers and the grounding generator
# ---------------------------------------------------------------------------

def test_swinv2_forward_features_matches_jax(tiny):
    t = tiny
    imgs = t["posi"].reshape((-1,) + t["posi"].shape[2:])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax.jit(lambda p, x: JS.forward_features(p, x, t["jcfg"].swin))(t["jp"]["swin"], imgs)
    for kernels in (False, True):
        with torch.inference_mode():
            got = PS.forward_features(t["pp"]["swin"], torch.from_numpy(imgs), t["pcfg"].swin,
                                      kernels=kernels)
        assert got.shape == ref.shape
        close(got, ref)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_htsat_forward_features_matches_jax(tiny, train):
    """Eval, and train without a generator (bn0 on the batch's statistics;
    JAX's rng=None draws no SpecAugment)."""
    t = tiny
    wave = t["wave"].reshape(-1, t["wave"].shape[-1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref, ref_s = jax.jit(lambda p, s, w: JH.forward_features(
            p, s, w, t["jcfg"].htsat, train=train))(t["jp"]["htsat"], t["js"]["htsat"], wave)
    with torch.inference_mode():
        got, got_s = PH.forward_features(t["pp"]["htsat"], t["ps"]["htsat"],
                                         torch.from_numpy(wave), t["pcfg"].htsat, train=train)
    close(got, ref)
    for k in ("mean", "var"):
        close(got_s["bn0"][k], ref_s["bn0"][k], msg=k)
    assert int(got_s["bn0"]["count"]) == int(ref_s["bn0"]["count"])


@pytest.fixture(scope="module")
def grounding(tiny):
    t = tiny
    jp, js = (to_numpy(x) for x in PG.init_grounding_model(t["pcfg"], seed=3, device="cpu"))
    pp, ps = from_jax(jp, js, t["pcfg"], device="cpu", grounding=True)
    visual = np.stack([t["posi"][:, 0], t["nega"][:, 0]], axis=1)
    return jp, js, pp, ps, visual


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_grounding_forward_matches_jax(tiny, grounding, train):
    t = tiny
    jp, js, pp, ps, visual = grounding
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref, ref_s = jax.jit(lambda p, s, w, v: JG.forward(p, s, w, v, t["jcfg"], train=train))(
            jp, js, t["wave"], visual)
    got = PG.forward(pp, ps, t["wave"], visual, t["pcfg"], train=train, device="cpu")
    got, got_s = got if train else (got, None)
    assert got.shape == (2 * t["wave"].shape[0], 2)
    close(got.detach(), ref)
    if train:
        close(got_s["htsat"]["bn0"]["mean"], ref_s["htsat"]["bn0"]["mean"])
    with pytest.raises(ValueError, match="AVQAModelConfig"):
        from_jax(jp, js, PC.AVEModelConfig(), device="cpu", grounding=True)


# ---------------------------------------------------------------------------
# the whole tiny model
# ---------------------------------------------------------------------------

def test_tiny_avqa_forward_matches_jax(tiny):
    """The three outputs against JAX's with the negative branch; without it,
    out_qa bit-identical and no out_match_nega; kernels on CPU tensors take
    the plain versions (K3's at four groups on the audio adapters, which
    have no BN and no gate)."""
    t = tiny
    got, ref = _port_forward(t), t["ref"]
    B, T = 2, t["pcfg"].num_frames
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "out_qa": (B, 42), "out_match_posi": (B * T, 2), "out_match_nega": (B * T, 2)}
    for k in OUTPUTS:
        close(got[k], ref[k], msg=k)
    bare = _port_forward(t, nega=None)
    assert sorted(bare) == ["out_match_posi", "out_qa"]
    assert torch.equal(bare["out_qa"], got["out_qa"])
    assert torch.equal(bare["out_match_posi"], got["out_match_posi"])
    on = _port_forward(t, nega=None, kernels=True)
    close(on["out_qa"], ref["out_qa"], msg="kernels on")
    # the adapters act: zero gates move the answer
    flat = {**t["pp"], "adapters": {k: [{**ap, "gate_av": 0 * ap["gate_av"]} for ap in v]
                                    for k, v in t["pp"]["adapters"].items()}}
    assert not torch.allclose(_port_forward(t, flat, nega=None)["out_qa"], got["out_qa"])


def test_negative_branch_reads_the_negative_frames(tiny):
    """The negative branch changes out_match_nega only."""
    t = tiny
    a, b = _port_forward(t), _port_forward(t, nega="posi")
    assert torch.equal(a["out_qa"], b["out_qa"])
    assert torch.equal(a["out_match_posi"], b["out_match_posi"])
    assert not torch.allclose(a["out_match_nega"], b["out_match_nega"])


def test_entry_points_need_the_card_unless_asked(tiny, monkeypatch):
    t = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PA.init_avqa_model(t["pcfg"]),
                 lambda: PG.init_grounding_model(t["pcfg"]),
                 lambda: PA.forward(t["pp"], t["ps"], t["wave"], t["posi"], None, t["q"],
                                    t["pcfg"]),
                 lambda: from_jax(t["jp"], t["js"], t["pcfg"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# DG-SCT's own AVQA modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["avqa_adapter_audio", "avqa_adapter_visual"])
@pytest.mark.parametrize("folded", [False, True], ids=["train_form", "folded"])
def test_avqa_adapter_matches_dgsct_golden(comp, folded):
    """AVQA's adapters (4 groups, 2 tokens, no BN; the visual one gated),
    also folded for serving as the engine runs them (K3's plain version)."""
    dim, N, odim, M, groups, tokens, use_bn, use_gate, B = ADAPTER_SPECS[comp]
    assert (groups, tokens, use_bn) == (4, 2, False)
    sd = rebuild_sd(load_census(comp))
    gold = np.load(outputs_path(comp))
    params, state = (to_torch(t) for t in PTC.convert_adapter(sd, "m", groups=groups))
    cfg = PC.AdapterConfig(reduction_factor=8, num_tokens=tokens, num_conv_group=groups,
                           use_bn=use_bn, use_gate=use_gate)
    if folded:
        params, state = PAd.fold_eval(params, state, cfg)
        assert "gate" not in params
    x = synth(f"__in__/{comp}/x", (B, dim, N, 1), is_input=True)
    vt = synth(f"__in__/{comp}/vt", (B, odim, M, 1), is_input=True)
    out, maps, _ = PAd.adapter(params, state,
                               torch.from_numpy(x[:, :, :, 0].transpose(0, 2, 1).copy()),
                               torch.from_numpy(vt[:, :, :, 0].transpose(0, 2, 1).copy()),
                               cfg, kernels=folded)
    close(out, gold["out"][:, :, :, 0].transpose(0, 2, 1), atol=2e-5, rtol=2e-4)
    close(maps, gold["maps"], atol=2e-6, rtol=2e-4)


def test_qst_encoder_matches_dgsct_golden():
    sd = rebuild_sd(load_census("avqa_qst_encoder"))
    gold = np.load(outputs_path("avqa_qst_encoder"))
    params = to_torch(PTC.convert_qst_encoder(sd, pre="m"))
    q = synth_tokens("__in__/avqa_qst/q", (3, 14), 93)
    close(PA.qst_encoder(params, torch.from_numpy(q)), gold["feat"], atol=5e-5, rtol=2e-4)


# ---------------------------------------------------------------------------
# int8: calibrate_avqa and the int8 forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(tiny):
    t = tiny
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        j = JQ.calibrate_avqa(t["jp"], t["js"], t["jcfg"], jnp.asarray(t["wave"]),
                              jnp.asarray(t["posi"]), jnp.asarray(t["q"]), min_dim=MIN_DIM)
    p = PQ.calibrate_avqa(t["pp"], t["ps"], t["pcfg"], t["wave"], t["posi"], t["q"],
                          min_dim=MIN_DIM, device="cpu")
    return j, p


def test_calibrate_avqa_matches_jax(tiny, calibrated):
    """The scales equal JAX's, whose negative branch (fed the positive frames)
    records under the Swin-V2 qids too: without that pass some maxima
    differ."""
    t = tiny
    j, p = calibrated
    assert sorted(p) == sorted(j) and len(p) > 10
    for q in j:
        np.testing.assert_allclose(p[q], j[q], rtol=1e-4, err_msg=f"qid {q}")
    recorder = PQ.Recorder()
    tagged = dict(t["pp"])
    tagged.update(PQ.attach_qtags(PQ._ordered_towers(t["pp"], ("swin", "htsat")),
                                  recorder=recorder, min_dim=MIN_DIM))
    with torch.inference_mode():
        PA.forward(tagged, t["ps"], t["wave"], t["posi"], None, t["q"], t["pcfg"],
                   kernels=False, device="cpu")
    posi_only = recorder.scales()
    assert sorted(posi_only) == sorted(j)
    assert any(not np.isclose(posi_only[q], j[q], rtol=1e-4) for q in j)


def _spread_err(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)


def test_int8_forward_matches_jax(tiny, calibrated):
    """The tiny int8-towers forward (JAX's static scales on both sides)
    within half of JAX's int8-against-float drift, per output."""
    t = tiny
    scales = calibrated[0]
    jq = JQ.quantize_eval_params(t["jp"], min_dim=MIN_DIM, act_scales=scales)
    pq = PQ.quantize_eval_params(t["pp"], min_dim=MIN_DIM, act_scales=scales)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        ref = jax.tree_util.tree_map(np.asarray, t["fwd"](jq, t["js"], t["wave"], t["posi"],
                                                          t["nega"], t["q"]))
    got = _port_forward(t, pq)
    for k in OUTPUTS:
        err, drift = _spread_err(got[k].numpy(), ref[k]), _spread_err(ref[k], t["ref"][k])
        assert drift > 1e-4, k  # the towers ran in int8
        assert err < DRIFT_SHARE * drift, (k, err, drift)
