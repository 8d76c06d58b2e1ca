"""The PyTorch port's ops (dg_sct_tpu_torch.ops: basic, dsp, windows, rnn,
mha) against the JAX package's, on the same numpy inputs, in float32 with
JAX at matmul precision "highest". Tolerance per module: atol 1e-4,
rtol 1e-3 unless a case states otherwise."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import AudioFrontendConfig as JFrontend
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.ops import dsp as JD
from dg_sct_tpu.ops import mha as JM
from dg_sct_tpu.ops import rnn as JR
from dg_sct_tpu.ops import windows as JW
from dg_sct_tpu_torch import configs as PC
from dg_sct_tpu_torch.ops import basic as PB
from dg_sct_tpu_torch.ops import dsp as PD
from dg_sct_tpu_torch.ops import mha as PM
from dg_sct_tpu_torch.ops import rnn as PR
from dg_sct_tpu_torch.ops import windows as PW
from torch_port_helpers import to_numpy, to_torch

ATOL, RTOL = 1e-4, 1e-3
FE = dict(sample_rate=3200, clip_seconds=1, n_fft=256, hop_size=320, mel_bins=16,
          fmax=1500.0, spec_size=32)


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref), atol=atol, rtol=rtol)


def params_pair(jparams):
    """A JAX param tree as (numpy tree, torch tree)."""
    n = to_numpy(jparams)
    return n, to_torch(n)


# ---------------------------------------------------------------------------
# numpy constants: copies equal to the JAX package's own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args,kw", [
    ("hann_window", (256,), {}),
    ("dft_basis", (256,), {}),
    ("dft_basis", (1024,), {}),
    ("mel_filterbank", (32000, 1024, 64, 50.0, 14000.0), {}),
    ("mel_filterbank", (3200, 256, 16, 50.0, 1500.0), {}),
    ("resize_matrix", (11, 128), {}),
    ("resize_matrix", (1001, 1024), {}),
    ("resize_matrix", (12, 7), {"kernel": "linear", "align_corners": False}),
])
def test_dsp_constants_equal(name, args, kw):
    a, b = getattr(PD, name)(*args, **kw), getattr(JD, name)(*args, **kw)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,args", [
    ("relative_position_index", (4, 4)), ("relative_position_index", (12, 12)),
    ("shift_attn_mask", (8, 8, 4, 2)), ("shift_attn_mask", (48, 48, 12, 6)),
    ("log_cpb_coords_table", (12, 12)), ("log_cpb_coords_table", (6, 6, 12)),
])
def test_window_constants_equal(name, args):
    np.testing.assert_array_equal(getattr(PW, name)(*args), getattr(JW, name)(*args))


# ---------------------------------------------------------------------------
# dsp
# ---------------------------------------------------------------------------

def test_power_spectrogram_logmel_wav2img():
    jcfg, pcfg = JFrontend(**FE), PC.AudioFrontendConfig(**FE)
    wave = np.random.RandomState(0).randn(3, jcfg.clip_samples).astype(np.float32)
    jp = JD.power_spectrogram(jnp.asarray(wave), jcfg)
    pp = PD.power_spectrogram(torch.from_numpy(wave), pcfg)
    close(pp, jp, atol=1e-3)                  # |power| up to ~1e3: rtol dominates
    jl, pl = JD.logmel(jp, jcfg), PD.logmel(pp, pcfg)
    close(pl, jl)
    close(PD.reshape_wav2img(pl, pcfg), JD.reshape_wav2img(jl, jcfg))


def test_power_spectrogram_bf16_inputs():
    """bf16 frames and basis with float32 sums, as JAX's bf16 GEMM with f32
    accumulation: the same products, so float32 tolerance (rtol 1e-3)."""
    jcfg, pcfg = JFrontend(**FE), PC.AudioFrontendConfig(**FE)
    wave = np.random.RandomState(1).randn(2, jcfg.clip_samples).astype(np.float32)
    jp = JD.power_spectrogram(jnp.asarray(wave), jcfg, jnp.bfloat16)
    pp = PD.power_spectrogram(torch.from_numpy(wave), pcfg, torch.bfloat16)
    close(pp, jp, atol=1e-3)


# ---------------------------------------------------------------------------
# basic
# ---------------------------------------------------------------------------

def test_patch_embed():
    jp, pp = params_pair(JB.patch_embed_init(jax.random.PRNGKey(0), 4, 3, 16))
    x = np.random.RandomState(0).rand(2, 16, 16, 3).astype(np.float32)
    close(PB.patch_embed(pp, torch.from_numpy(x), 4), JB.patch_embed(jp, jnp.asarray(x), 4))


def test_grouped_linear():
    jp, pp = params_pair(JB.grouped_linear_init(jax.random.PRNGKey(1), 32, 8, 2, bias=True))
    x = np.random.RandomState(1).randn(3, 5, 32).astype(np.float32)
    close(PB.grouped_linear(pp, torch.from_numpy(x)), JB.grouped_linear(jp, jnp.asarray(x)))


def test_batch_norm_eval():
    rs = np.random.RandomState(2)
    p = {"scale": rs.rand(16).astype(np.float32) + 0.5, "bias": rs.randn(16).astype(np.float32)}
    s = {"mean": rs.randn(16).astype(np.float32), "var": rs.rand(16).astype(np.float32) + 0.1,
         "count": np.zeros((), np.int32)}
    x = rs.randn(2, 7, 16).astype(np.float32)
    ref, _ = JB.batch_norm(p, s, jnp.asarray(x), train=False, axis=-1)
    close(PB.batch_norm(to_torch(p), to_torch(s), torch.from_numpy(x), axis=-1)[0], ref)


@pytest.mark.parametrize("mode", ["exact", "tanh"])
def test_mlp_gelu_modes(mode):
    jp, pp = params_pair(JB.mlp_init(jax.random.PRNGKey(2), 24, 96))
    x = np.random.RandomState(3).randn(4, 24).astype(np.float32)
    act = (lambda v: jax.nn.gelu(v, approximate=(mode == "tanh")))
    close(PB.mlp(pp, torch.from_numpy(x), mode), JB.mlp(jp, jnp.asarray(x), act=act))


def test_layer_norm_and_linear():
    jp, pp = params_pair(JB.linear_init(jax.random.PRNGKey(3), 24, 40))
    rs = np.random.RandomState(4)
    ln = {"scale": rs.rand(40).astype(np.float32), "bias": rs.randn(40).astype(np.float32)}
    x = rs.randn(5, 24).astype(np.float32)
    ref = JB.layer_norm(ln, JB.linear(jp, jnp.asarray(x)))
    close(PB.layer_norm(to_torch(ln), PB.linear(pp, torch.from_numpy(x))), ref)


def test_wire_formats():
    rs = np.random.RandomState(5)
    frames = rs.randint(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    close(PB.normalize_frames_u8(torch.from_numpy(frames), torch.float32),
          JB.normalize_frames_u8(jnp.asarray(frames), jnp.float32), atol=1e-6, rtol=1e-6)
    mulaw = rs.randint(0, 256, (3, 50), dtype=np.uint8)
    close(PB.dequantize_mulaw_u8(torch.from_numpy(mulaw)),
          JB.dequantize_mulaw_u8(jnp.asarray(mulaw)), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# windows (plain path; the kernels' own tests are in test_torch_kernels.py)
# ---------------------------------------------------------------------------

def test_window_partition_reverse():
    x = np.random.RandomState(6).randn(2, 8, 12, 5).astype(np.float32)
    wins = PW.window_partition(torch.from_numpy(x), 4)
    close(wins, JW.window_partition(jnp.asarray(x), 4), atol=0, rtol=0)
    close(PW.window_reverse(wins, 4, 8, 12), x, atol=0, rtol=0)


def _windows_input(C, seed):
    return np.random.RandomState(seed).randn(2, 64, C).astype(np.float32)


@pytest.mark.parametrize("kind,shift,kernels", [
    ("v1", 0, False), ("v1", 2, False), ("v2", 0, False), ("v2", 2, False),
    ("v1", 2, True), ("v2", 2, True)])
def test_shifted_window_attention(kind, shift, kernels):
    """V1 / V2 attention through the shifted-window step; kernels=True on a
    CPU tensor runs K1's plain version through the wrapper."""
    C, heads, ws = 16, 2, 4
    if kind == "v1":
        jp = JW.attention_v1_init(jax.random.PRNGKey(4), C, ws, heads)
    else:
        jp = JW.attention_v2_init(jax.random.PRNGKey(4), C, heads)
        jp["q_bias"] = jnp.asarray(np.random.RandomState(7).randn(C).astype(np.float32) * 0.1)
        jp["v_bias"] = jnp.asarray(np.random.RandomState(8).randn(C).astype(np.float32) * 0.1)
    jp, pp = params_pair(jp)
    jfn, pfn = ((JW.window_attention_v1, PW.window_attention_v1) if kind == "v1"
                else (JW.window_attention_v2, PW.window_attention_v2))
    x = _windows_input(C, 9)
    ref = JW.shifted_window_attention(
        lambda w, m, nw: jfn(jp, w, num_heads=heads, ws=ws, mask=m, nW=nw),
        jnp.asarray(x), H=8, W=8, ws=ws, shift=shift)
    got = PW.shifted_window_attention(
        lambda w, m, nw: pfn(pp, w, num_heads=heads, ws=ws, mask=m, nW=nw, kernels=kernels),
        torch.from_numpy(x), H=8, W=8, ws=ws, shift=shift)
    close(got, ref)


# ---------------------------------------------------------------------------
# rnn, mha
# ---------------------------------------------------------------------------

def test_bilstm():
    jp, pp = params_pair(JR.bilstm_init(jax.random.PRNGKey(5), 12, 8))
    x = np.random.RandomState(10).randn(3, 10, 12).astype(np.float32)
    close(PR.bilstm(pp, torch.from_numpy(x)), JR.bilstm(jp, jnp.asarray(x)))


def test_mha():
    jp = JM.mha_init(jax.random.PRNGKey(6), 16)
    jp["in_proj"]["bias"] = jnp.asarray(np.random.RandomState(11).randn(48).astype(np.float32))
    jp, pp = params_pair(jp)
    rs = np.random.RandomState(12)
    q, kv = rs.randn(10, 2, 16).astype(np.float32), rs.randn(20, 2, 16).astype(np.float32)
    ref = JM.mha(jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), num_heads=4)
    got = PM.mha(pp, torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv), num_heads=4)
    close(got, ref)
