"""The port's float32 train-mode adapter VJP against the JAX package's, at a
small width, on inputs shaped like the last paired step's two p2 adapters of
the full-width AVE train step (`perf/torch_f32_probe.py --capture 46 47`):
the audio stream's tokens with a per-token |mean| / std of ~0.02 (the
capture reads a median of 0.021 and a max of 0.096), the video stream's
~0 (0.000 in the capture); each stream is x for one adapter and other for
the other one. Batch statistics in both BNs, the clips in order and
reversed.

Tolerances: the two packages' float64 gradients agree within 1e-10 relative
L2 (they agree within 4e-14 at full width); each package's float32
gradients of x, other and all parameters together lie within 1e-4 of its
float64 ones (float32's own rounding: ~1e-5 at full width, ~1e-6 here; a
product taken in TF32 or bf16 would read 1e-3 or more); and the port's
float32 error is within 2x JAX's unless both are below 1e-5, the rule
`perf/f32_adapter_vjp.py` applies to the captured calls (PERF.md §6).
JAX runs at matmul precision "highest" (tests/conftest.py), its float64 side
under `jax.enable_x64`."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.configs import AdapterConfig as JAdapterConfig
from dg_sct_tpu.models import adapter as JA
from dg_sct_tpu_torch.configs import AdapterConfig as PAdapterConfig
from dg_sct_tpu_torch.models import adapter as PA
from torch_port_helpers import to_numpy

CLIPS, FRAMES = 4, 2
AUDIO, VIDEO = (64, 32), (36, 64)  # (tokens, channels) of each stream
AUDIO_RATIO = 0.02                 # per-token |mean| / std of the audio stream (median)
F64_AGREE, F32_OWN, RATIO, FLOOR = 1e-10, 1e-4, 2.0, 1e-5


def streams(seed):
    """(audio, video) tokens, (CLIPS * FRAMES, N, C) float64."""
    rs = np.random.RandomState(seed)
    rows = CLIPS * FRAMES
    unit = lambda a: (a - a.mean(-1, keepdims=True)) / a.std(-1, keepdims=True)
    # |mean| of a token: |N(0, s)| has median 0.6745 s
    audio = unit(rs.randn(rows, *AUDIO)) + AUDIO_RATIO / 0.6745 * rs.randn(rows, AUDIO[0], 1)
    return audio, unit(rs.randn(rows, *VIDEO))


def token_ratio(a):
    return np.median(np.abs(a.mean(-1)) / a.std(-1))


def adapter_case(kind, seed=0):
    """An a_p2-like ("audio": x the audio stream) or v_p2-like ("video") call:
    (params, state, x, other, g_res, g_maps), numpy float64."""
    audio, video = streams(seed)
    x, other = (audio, video) if kind == "audio" else (video, audio)
    N, C = x.shape[1:]
    M, D = other.shape[1:]
    p, s = JA.init_adapter(jax.random.PRNGKey(seed + 1), dim=C, other_dim=D, num_tokens_self=N,
                           num_tokens_other=M, cfg=JAdapterConfig())
    p, s = to_numpy(p), to_numpy(s)
    rs = np.random.RandomState(seed + 2)
    p["gate"] = np.asarray([0.4], np.float32)
    p["gate_av"] = np.asarray([0.5], np.float32)
    for bn in ("bn1", "bn2"):
        n = p[bn]["scale"].shape[0]
        p[bn] = {"scale": (1.0 + 0.2 * rs.randn(n)).astype(np.float32),
                 "bias": (0.1 * rs.randn(n)).astype(np.float32)}
    f64 = lambda t: {k: f64(v) for k, v in t.items()} if isinstance(t, dict) else \
        (np.asarray(t, np.float64) if np.asarray(t).dtype.kind == "f" else np.asarray(t))
    g_res, g_maps = rs.randn(*x.shape), rs.randn(x.shape[0], 1, N)
    return f64(p), f64(s), x, other, g_res, g_maps


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def reorder(a, reverse):
    if not reverse:
        return a
    return np.ascontiguousarray(a.reshape((CLIPS, -1) + a.shape[1:])[::-1].reshape(a.shape))


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.astype(dtype) if tree.dtype.kind == "f" else tree


@jax.jit
def _jax_vjp(params, state, x, other, g_res, g_maps):
    def f(x, o, p):
        res, maps, _ = JA.adapter(p, state, x, o, JAdapterConfig(), train=True)
        return res, maps

    return jax.vjp(f, x, other, params)[1]((g_res, g_maps))


def jax_grads(case, dtype, reverse):
    p, s, x, other, g_res, g_maps = case
    r = lambda a: jnp.asarray(reorder(a, reverse).astype(dtype))

    def run():
        tree = lambda t: jax.tree_util.tree_map(jnp.asarray, cast(t, dtype))
        gx, go, gp = _jax_vjp(tree(p), tree(s), r(x), r(other), r(g_res), r(g_maps))
        return np.asarray(gx, np.float64), np.asarray(go, np.float64), {
            k: np.asarray(v, np.float64) for k, v in leaves(gp)}

    if dtype == np.float64:
        with jax.enable_x64(True):
            gx, go, gp = run()
    else:
        gx, go, gp = run()
    return reorder(gx, reverse), reorder(go, reverse), gp


def port_grads(case, dtype, reverse):
    p, s, x, other, g_res, g_maps = case
    t = lambda a: torch.from_numpy(reorder(a, reverse).astype(dtype))
    conv = lambda tree: {k: conv(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(tree.astype(dtype) if tree.dtype.kind == "f" else tree)
    pp, ps = conv(p), conv(s)
    named = leaves(pp)
    for _, v in named:
        v.requires_grad_()
    xt, ot = t(x).requires_grad_(), t(other).requires_grad_()
    res, maps, _ = PA.adapter(pp, ps, xt, ot, PAdapterConfig(), kernels=False, train=True)
    g = torch.autograd.grad([res, maps], [xt, ot] + [v for _, v in named],
                            grad_outputs=[t(g_res), t(g_maps)], allow_unused=True)
    back = lambda a: reorder(a.double().numpy(), reverse)
    return back(g[0]), back(g[1]), {k: (np.zeros(v.shape) if gk is None else gk.double().numpy())
                                    for (k, v), gk in zip(named, g[2:])}


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def errors(got, ref):
    """Relative L2 of the gradients of x, of other and of all parameters."""
    cat = lambda g: np.concatenate([g[2][k].reshape(-1) for k in sorted(ref[2])])
    return {"x": rel(got[0], ref[0]), "other": rel(got[1], ref[1]),
            "params": rel(cat(got), cat(ref))}


def test_inputs_match_the_captured_ratios():
    audio, video = streams(0)
    assert 0.01 < token_ratio(audio) < 0.04
    assert token_ratio(video) < 1e-6


@pytest.fixture(scope="module")
def references():
    """Each case's float64 gradients in both packages."""
    out = {}
    for kind in ("audio", "video"):
        case = adapter_case(kind)
        out[kind] = (case, jax_grads(case, np.float64, False), port_grads(case, np.float64, False))
    return out


@pytest.mark.parametrize("kind", ["audio", "video"])
@pytest.mark.parametrize("reverse", [False, True], ids=["in_order", "reversed"])
def test_f32_adapter_vjp_port_against_jax(references, kind, reverse):
    case, j64, p64 = references[kind]
    agree = errors(p64, j64)
    assert max(agree.values()) < F64_AGREE, agree
    j32 = errors(jax_grads(case, np.float32, reverse), j64)
    p32 = errors(port_grads(case, np.float32, reverse), p64)
    for k in ("x", "other", "params"):
        assert j32[k] < F32_OWN and p32[k] < F32_OWN, (k, j32[k], p32[k])
        assert p32[k] <= RATIO * j32[k] or max(p32[k], j32[k]) < FLOOR, (k, j32[k], p32[k])
