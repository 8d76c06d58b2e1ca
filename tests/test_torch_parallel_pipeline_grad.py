"""The backward through the port's GPipe (dg_sct_tpu_torch.parallel.pipeline)
against `jax.grad` of the JAX package's `gpipe`, in gloo worlds of spawned
CPU ranks (tests/torch_parallel_worker.py), float32.

One 4-rank world at tests/test_pipeline.py:124's shapes (n_stages 4,
n_micro 3, d 8; JAX on its 4-device CPU mesh), loss sum(y^2) from the
replicated outputs on every rank: each rank's gradient for its own stage and
the microbatches' gradient on every rank within 1e-5 of JAX's, for the
stages stacked, as a list, a tree carry, a frozen stage, a frozen first stage
fed microbatches that need no gradient (rank 0 then holds nothing that
requires grad and must still take part in the backward) and microbatches
made upstream on every rank. One 2-rank world: every parameter leaf's gradient of
the pipelined eval forward at `pipe_cfg()` (kernels off, exact GELU) against
`jax.grad` of JAX's unpipelined eval forward; with the kernels on the same
forward raises (`ops/kernels/build.refuse_grad`). Each leaf is held within
1e-3 of its largest JAX gradient plus 10 times the port's own move under a
1e-6 relative nudge of the inputs, as tests/avs_train_parity.py holds the
train step: the adapters' scalar `aff_v_s_att` biases sum cancelling terms,
and there float32 rounding alone puts the port's one-process gradient 1.7e-3
of the leaf from JAX's, and the pipelined one 1.0e-3 from the one-process
one. JAX's gradient of the eval forward is taken in two jitted pieces, which
still compile for ~45 s on the CPU, so both worlds and the port's own
gradients run on threads meanwhile.
"""
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dg_sct_tpu.models import interleave as JI
from dg_sct_tpu.models.heads import ave as JH
from dg_sct_tpu.ops import basic as JB
from dg_sct_tpu.parallel import pipeline as PP
from dg_sct_tpu.parallel.mesh import make_mesh
from dg_sct_tpu_torch.models import ave as PA
from dg_sct_tpu_torch.utils.tree import tree_paths
from dg_sct_tpu_torch.weights import from_jax
import torch_parallel_worker as W
from test_pipeline import _mlp_body, _mlp_stage_params
from test_torch_parallel_pipeline import pipe_cfg
from torch_port_helpers import port_cfg, scramble_adapters, to_numpy

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_SHARE = 1e-3      # the model's leaves: of the leaf's largest JAX gradient,
NUDGE = 1e-6           # plus NUDGE_FACTOR times the port's own move under a NUDGE
NUDGE_FACTOR = 10.0    # (relative) change of the inputs (tests/avs_train_parity.py)
CASES = ("stacked", "list", "tree", "frozen", "frozen_first", "pre")
N_STAGES, N_MICRO, D = 4, 3, 8


def _pair_body(p, x):
    a, b = x
    a = a + jnp.tanh(a @ p["w1"]) @ p["w2"]
    return (a, b + 0.5 * a)


class _Thread(threading.Thread):
    """`fn(*args)` on a thread, so that the worlds' ranks and the port's own
    gradients run while this process traces and compiles JAX's references;
    `result()` joins and re-raises."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self.fn, self.args, self.out, self.err = fn, args, None, None
        self.start()

    def run(self):
        try:
            self.out = self.fn(*self.args)
        except BaseException as e:     # re-raised in the test's process
            self.err = e

    def result(self):
        self.join()
        if self.err is not None:
            raise self.err
        return self.out


def _model_inputs():
    jcfg = pipe_cfg()
    pcfg = port_cfg(jcfg)
    jp, js = scramble_adapters(*(to_numpy(t) for t in PA.init_ave_model(pcfg, device="cpu")))
    rs = np.random.RandomState(4)
    wave = rs.randn(2, 2, jcfg.htsat.frontend.clip_samples).astype(np.float32)
    images = rs.rand(2, 2, 64, 64, 3).astype(np.float32)
    return jcfg, pcfg, jp, js, wave, images


def _nudged(a, seed):
    if seed is None:
        return a
    return (a * (1.0 + NUDGE * np.random.RandomState(seed).randn(*a.shape))).astype(np.float32)


def _one_process_grads(pcfg, jp, js, wave, images, wts):
    """The port's unpipelined eval forward (kernels off), differentiated in
    this process -> each floating leaf's gradient by path (None: unread)."""
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    leaves = [(p, t.requires_grad_()) for p, t in tree_paths(pp) if t.is_floating_point()]
    out = PA.forward(pp, ps, wave, images, pcfg, kernels=False, device="cpu")
    sum((torch.as_tensor(w) * out[k]).sum() for k, w in wts.items()).backward()
    return {"/".join(map(str, p)): None if t.grad is None else t.grad.numpy() for p, t in leaves}


def _one_process_moves(pcfg, jp, js, wave, images, wts):
    """The port's own float32 conditioning, leaf by leaf: the largest move of
    one process's gradient when the inputs are nudged by NUDGE (relative),
    seeds 1 and 2."""
    one = [_one_process_grads(pcfg, jp, js, _nudged(wave, seed), _nudged(images, seed), wts)
           for seed in (None, 1, 2)]
    return {p: max(float(np.abs(o[p] - g).max()) for o in one[1:]) for p, g in one[0].items()
            if g is not None}


def _jax_eval_grad(jcfg, jp, js, wave, images, wts):
    """`jax.value_and_grad` of sum(wts[k] * out[k]) with `out` the JAX
    package's eval forward (`dg_sct_tpu.models.ave.forward`) -> (loss,
    gradient tree), taken as the chain of jitted VJPs of its two parts: the
    towers (`interleave.forward`) and the steps after them, the heads. XLA
    compiles the parts in about half the time of one jit of the whole on the
    CPU (~45 s against ~90 s), and the towers' backward compiles on a thread
    while the forward and the heads run. The loss is held to the port's,
    whose eval forward tests/test_torch_parallel_pipeline.py holds to
    JAX's."""
    B, T = wave.shape[:2]
    towers = jax.jit(lambda p: JI.forward(p, js, wave.reshape(B * T, -1),
                                          images.reshape((B * T,) + images.shape[2:]), jcfg)[0])

    def heads_loss(p, feats):
        f_v, f_a = (feats[k].reshape(B, T, -1) for k in ("f_v", "f_a"))
        video_q, audio_q, _ = JH.temporal_attention(p["temporal_attn"], f_v, f_a)
        is_event, event, _ = JH.cmbs(p["CMBS"], video_q, audio_q)
        out = {"event_scores": event, "is_event_scores": is_event[..., 0].transpose(1, 0)}
        return sum(jnp.sum(w * out[k]) for k, w in wts.items())

    traced = towers.trace(jp)          # the towers' jaxpr, shared by both jits
    feats_like = jax.tree_util.tree_map(lambda o: jax.ShapeDtypeStruct(o.shape, o.dtype),
                                        traced.out_info)
    backward = _Thread(lambda: jax.jit(lambda p, ct: jax.vjp(towers, p)[1](ct)[0])
                       .lower(jp, feats_like).compile())
    feats = traced.lower().compile()(jp)
    loss, (g_heads, g_feats) = jax.jit(jax.value_and_grad(heads_loss, argnums=(0, 1)))(jp, feats)
    add = lambda a, b: a + b if jnp.issubdtype(a.dtype, jnp.floating) else a
    return float(loss), jax.tree_util.tree_map(add, backward.result()(jp, g_feats), g_heads)


def _jax_gpipe_grads(stages, xs, w0):
    """`jax.grad` through the JAX package's `gpipe` on the 4-device CPU mesh,
    for each loss of `gpipe_grad_cases`: the MLP stages ("plain"), the tree
    carry ("tree") and microbatches made upstream from w0 ("pre")."""
    stacked = PP.stack_stages(stages)
    mesh = make_mesh(4, axis=PP.PIPE_AXIS)
    plain = jax.grad(lambda st, x: jnp.sum(PP.gpipe(_mlp_body, st, x, mesh) ** 2),
                     argnums=(0, 1))(stacked, xs)

    def tree_loss(st, a, b):
        ya, yb = PP.gpipe(_pair_body, st, (a, b), mesh)
        return jnp.sum(ya ** 2) + 0.5 * jnp.sum(yb ** 2)

    tree = jax.grad(tree_loss, argnums=(0, 1, 2))(stacked, xs, 0.5 * xs)
    pre = jax.grad(lambda st, w, x: jnp.sum(PP.gpipe(_mlp_body, st, jnp.tanh(x @ w), mesh) ** 2),
                   argnums=(0, 1, 2))(stacked, w0, xs)
    return {"plain": to_numpy(plain), "tree": to_numpy(tree), "pre": to_numpy(pre)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds and the port's own gradients (started first, on threads)
    and JAX's references, each once: the 4-rank MLP cases and the 2-rank
    pipelined eval forward."""
    torch.set_num_threads(2)
    stages = _mlp_stage_params(jax.random.PRNGKey(8), N_STAGES, D, D)
    xs = jax.random.normal(jax.random.PRNGKey(9), (N_MICRO, 2, D))
    w0 = 0.3 * jax.random.normal(jax.random.PRNGKey(10), (D, D))
    mlp_world = _Thread(W.run_world, W.gpipe_grad_cases, 4, tmp_path_factory.mktemp("gpipe_grad"),
                        list(CASES), to_numpy(stages), np.asarray(xs), np.asarray(w0))
    jcfg, pcfg, jp, js, wave, images = _model_inputs()
    B, T = wave.shape[:2]
    n_cls = jp["CMBS"]["localize_event"]["kernel"].shape[-1]
    shapes = {"event_scores": (B, n_cls), "is_event_scores": (B, T)}
    wts = {k: np.random.RandomState(5 + i).randn(*shape).astype(np.float32)
           for i, (k, shape) in enumerate(shapes.items())}
    model_world = _Thread(W.run_world, W.ave_pipe_grad, 2, tmp_path_factory.mktemp("pipe_grad"),
                          pcfg, jp, js, wave, images, 2, wts)
    moves = _Thread(_one_process_moves, pcfg, jp, js, wave, images, wts)
    mlp_ref = _Thread(_jax_gpipe_grads, stages, xs, w0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "_GELU_MODE", "exact")
        model_loss, model_ref = _jax_eval_grad(jcfg, jp, js, wave, images, wts)
    path = lambda p: "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
    model_ref = {path(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(model_ref)[0]}

    got = mlp_world.result()
    return {"mlp": (mlp_ref.result(), {case: [r[i] for r in got] for i, case in enumerate(CASES)}),
            "model": (model_loss, model_ref, model_world.result(), moves.result())}


@pytest.mark.parametrize("case", CASES)
def test_gpipe_gradients_match_jax_over_4_ranks(runs, case):
    ref, got = runs["mlp"]
    g_stages, g_xs = (ref["tree"][:2] if case == "tree" else
                      (ref["pre"][0], ref["pre"][2]) if case == "pre" else ref["plain"])
    for rank, r in enumerate(got[case]):
        for i, g in enumerate(r["stages"]):
            if (case, i) in (("frozen", 1), ("frozen_first", 0)):
                assert all(v is None for v in g.values()), (rank, i)
            elif i == rank:          # this rank's own stage
                for k in ("w1", "w2"):
                    np.testing.assert_allclose(g[k], g_stages[k][i], err_msg=f"{rank} {i} {k}",
                                               **GRAD_TOL)
            elif case == "stacked":  # the other ranks' slots of the stacked leaves
                assert all(not np.any(v) for v in g.values()), (rank, i)
            else:
                assert all(v is None for v in g.values()), (rank, i)
        # the microbatches' gradient, the sequential loop's, on every rank
        if case == "frozen_first":
            assert r["xs"] is None, rank
        else:
            np.testing.assert_allclose(r["xs"], g_xs, err_msg=f"rank {rank}", **GRAD_TOL)
        if case == "tree":
            np.testing.assert_allclose(r["xs_b"], ref["tree"][2], **GRAD_TOL)
        if case == "pre":
            np.testing.assert_allclose(r["w0"], ref["pre"][1], **GRAD_TOL)
        assert r["loss"] == got[case][0]["loss"]


def test_pipelined_eval_gradient_matches_jax_over_2_ranks(runs):
    ref_loss, ref, ranks, move = runs["model"]
    for r in ranks:
        assert r["pipelined"] == [2], r["pipelined"]
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-5)
    float_ref = {p: g for p, g in ref.items() if np.issubdtype(g.dtype, np.floating)}
    assert set(ranks[0]["grads"]) == set(float_ref)
    for path, g_ref in float_ref.items():
        got = [r["grads"][path] for r in ranks]
        if all(g is None for g in got):       # a leaf the eval forward never reads
            assert not np.any(g_ref), path
            continue
        tol = GRAD_SHARE * float(np.abs(g_ref).max()) + NUDGE_FACTOR * move[path]
        for rank, g in enumerate(got):
            if g is not None:
                assert np.abs(g - g_ref).max() <= tol, (path, rank, np.abs(g - g_ref).max(), tol)
        if "/layers/2/" in f"/{path}/" or path.startswith("adapters/"):
            continue                          # stage 2's pairs: on their own rank only
        assert all(g is not None for g in got), path


def test_pipelined_eval_refuses_a_gradient_with_kernels_on(runs):
    for r in runs["model"][2]:
        assert "no backward" in (r["kernels_error"] or ""), r["kernels_error"]
