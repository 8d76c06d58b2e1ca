"""Rank bodies of the port's parallel-mode tests and the worlds that run them.

Imports neither jax nor pytest, so a spawned rank starts fast. `run_world`
starts one process per rank with the `spawn` method, a gloo world through a
`file://` rendezvous under a test's temporary directory (never a fixed
port: parallel test workers share the host), a timeout on every group
(`parallel.mesh.TIMEOUT`) and on every join; the ranks' results come back as numpy trees in rank order.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 240.0


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _entry(rank, world, init_file, start, fn, args, results):
    torch.set_num_threads(1)
    try:
        if start:
            from dg_sct_tpu_torch.parallel import mesh
            mesh.init_world("gloo", f"file://{init_file}", rank, world)
            out = fn(rank, world, *args)
        else:
            out = fn(rank, world, init_file, *args)
        results.put((rank, "ok", to_numpy(out)))
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, "error", traceback.format_exc()))


def run_world(fn, world: int, tmp_dir, *args, start=True):
    """fn(rank, world, *args) in `world` spawned ranks of a gloo world ->
    [each rank's result]; with start=False fn(rank, world, init_file,
    *args) starts the world itself from the `file://` rendezvous at
    init_file. A rank's exception, or a rank that does not end within
    JOIN_TIMEOUT_S, raises here; every rank is gone when this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_file = os.path.join(str(tmp_dir), f"world_{os.getpid()}_{id(results)}")
    procs = [ctx.Process(target=_entry, args=(r, world, init_file, start, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while len(got) < world and not errors:
            try:
                rank, status, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in got]
                if dead:
                    errors.append(f"ranks {dead} ended without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"the world did not finish within {JOIN_TIMEOUT_S} s")
                continue
            if status == "ok":
                got[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            p.join(timeout=10 if errors else JOIN_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _ave_port(pcfg, jp, js):
    from dg_sct_tpu_torch.train import ave_train
    from dg_sct_tpu_torch.weights import from_jax
    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    tr, fr = ave_train.partition_params(pp)
    return tr, fr, ps


def ave_steps(rank, world, pcfg, jp, js, batches, train_kw, seed, dtype=torch.float32):
    """The port's AVE train step over `batches` (global batches), on this
    rank's rows with data parallelism over the world (world 1: one process
    on the whole batch), in `dtype` (the weights, the batches and the
    compute); `seed` seeds a generator (None: no draws). Per mini-step:
    loss, acc, the new state, the accumulated gradient and the trainable
    leaves after it."""
    import dataclasses
    from dg_sct_tpu_torch.configs import TrainConfig
    from dg_sct_tpu_torch.parallel import mesh
    from dg_sct_tpu_torch.train import ave_train
    from dg_sct_tpu_torch.utils.tree import tree_map

    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    tr, fr, state = (tree_map(cast, t) for t in _ave_port(pcfg, jp, js))
    opt = ave_train.make_optimizer(tr, TrainConfig(**train_kw), steps_per_epoch=1)
    opt_state = opt.init(tr)
    data = mesh.make_mesh(world) if world > 1 else None
    group = data.group(mesh.DATA_AXIS) if world > 1 else None
    step = ave_train.make_train_step(dataclasses.replace(pcfg, compute_dtype=dtype), opt,
                                     device="cpu", group=group)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    run = []
    for b in batches:
        b = {k: cast(torch.as_tensor(v)) for k, v in b.items()}
        local = mesh.shard_batch(b, data) if group is not None else b
        tr, state, opt_state, m = step(tr, fr, state, opt_state, local, gen)
        run.append({"loss": float(m["loss"]), "acc": float(m["acc"]), "state": state,
                    "acc_grads": opt_state["acc"], "mu": opt_state["mu"], "trainable": tr})
    return run


def task_step(rank, world, task, pcfg, jp, js, batch, train_kw):
    """One AVS-S4 ("avs") or AVQA stage-2 ("avqa") train step of the port on
    this rank's rows, no generator -> (loss, the trainable leaves after)."""
    from dg_sct_tpu_torch.configs import TrainConfig
    from dg_sct_tpu_torch.parallel import mesh
    from dg_sct_tpu_torch.train import ave_train, avqa_train, avs_train
    from dg_sct_tpu_torch.weights import from_jax

    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    tr, fr = ave_train.partition_params(pp)
    opt = ave_train.make_optimizer(tr, TrainConfig(**train_kw), steps_per_epoch=1)
    data = mesh.make_mesh(world) if world > 1 else None
    group = data.group(mesh.DATA_AXIS) if world > 1 else None
    make = {"avs": lambda: avs_train.make_train_step(pcfg, opt, task="s4", device="cpu",
                                                     group=group),
            "avqa": lambda: avqa_train.make_train_step(pcfg, opt, device="cpu", group=group)}
    step = make[task]()
    local = mesh.shard_batch(batch, data) if group is not None else batch
    tr, _, _, m = step(tr, fr, ps, opt.init(tr), local)
    return {"loss": float(m["loss"]), "trainable": tr}


def ave_main_smoke(rank, world, init_file, pcfg, argv):
    """`ave_main.main(argv)` as rank `rank` of a gloo world it starts itself
    on the CPU -> its smoke result."""
    from dg_sct_tpu_torch.train import ave_main
    return ave_main.main(argv + ["--device", "cpu", "--dist-backend", "gloo", "--world-size",
                                 str(world), "--rank", str(rank), "--init-method",
                                 f"file://{init_file}"], cfg=pcfg)


# ---------------------------------------------------------------------------
# tensor, sequence and pipeline parallel eval
# ---------------------------------------------------------------------------

def ave_eval(rank, world, mode, shape, pcfg, jp, js, wave, images, n_micro=None):
    """The port's AVE eval forward (kernels off) under `mode`: "tp" over a
    (data, model) mesh of `shape`, "sp" over (data, seq), "pipe" over a 1-D
    pipe of the world with `n_micro` microbatches. -> this rank's outputs,
    its (data index, data size), for "pipe" the pipelined stages, and the
    shape of each leaf of the params it held."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.parallel import mesh
    from dg_sct_tpu_torch.parallel.tp import TensorParallel
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    batch = {"wave": wave, "image": images}
    kw = {}
    if mode == "tp":
        m = mesh.make_mesh_2d(*shape)
        pp = mesh.tp_shard_params(pp, m)
        batch = mesh.shard_batch(batch, m)
        kw["tp"] = TensorParallel(m.group(mesh.MODEL_AXIS))
    elif mode == "sp":
        m = mesh.make_mesh_2d_seq(*shape)
        batch = mesh.shard_batch_seq(batch, m)
        kw["seq"] = m.group(mesh.SEQ_AXIS)
    else:
        m = mesh.make_mesh(world, mesh.PIPE_AXIS)
        kw["pipeline"] = (m.group(mesh.PIPE_AXIS), n_micro)
    with torch.inference_mode():
        out = ave.forward(pp, ps, batch["wave"], batch["image"], pcfg, kernels=False,
                          device="cpu", **kw)
    data = (m.index(mesh.DATA_AXIS), m.size(mesh.DATA_AXIS)) if mode != "pipe" else (0, 1)
    return {"out": {k: v for k, v in out.items() if k != "pipelined_stages"}, "data": data,
            "pipelined": list(out.get("pipelined_stages", ())),
            "shapes": {"/".join(map(str, p)): list(t.shape) for p, t in tree_paths(pp)}}


def mlp_stages(n_stages, d, hidden, seed):
    g = torch.Generator().manual_seed(seed)
    return [{"w1": torch.randn(d, hidden, generator=g) * 0.1,
             "w2": torch.randn(hidden, d, generator=g) * 0.1} for _ in range(n_stages)]


def mlp_body(p, x):
    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


def pair_body(p, x):
    a, b = x
    a = a + torch.tanh(a @ p["w1"]) @ p["w2"]
    return [a, b + 0.5 * a]


def gpipe_cases(rank, world, cases):
    """gpipe over the whole world for each (kind, n_stages, n_micro,
    stacked) of `cases`: "mlp" on (n_micro, 4, 16) inputs, "pair" a tree
    carry of two (n_micro, 2, 8) tensors; stages as a list, or stacked
    (`stack_stages`). -> per case the outputs and the sequential loop's, or
    the ValueError's message where gpipe raised."""
    from dg_sct_tpu_torch.parallel import pipeline as PP

    results = []
    for kind, n_stages, n_micro, stacked in cases:
        g = torch.Generator().manual_seed(100 + n_stages)
        if kind == "mlp":
            stages, body = mlp_stages(n_stages, 16, 32, 0), mlp_body
            xs = torch.randn(n_micro, 4, 16, generator=g)
            seq = [xs[m] for m in range(n_micro)]
            for st in stages:
                seq = [body(st, x) for x in seq]
            ref = torch.stack(seq)
        else:
            stages, body = mlp_stages(n_stages, 8, 8, 2), pair_body
            xs = [torch.randn(n_micro, 2, 8, generator=g), torch.randn(n_micro, 2, 8, generator=g)]
            outs = []
            for m in range(n_micro):
                x = [xs[0][m], xs[1][m]]
                for st in stages:
                    x = body(st, x)
                outs.append(x)
            ref = [torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])]
        try:
            got = PP.gpipe(body, PP.stack_stages(stages) if stacked else stages, xs, None)
        except ValueError as e:
            results.append({"error": str(e)})
            continue
        results.append({"got": got, "ref": ref})
    return results


def gpipe_grad_cases(rank, world, cases, stages_np, xs_np, pre_np):
    """The backward through gpipe over the whole world, on the loss every
    rank computes from its replicated outputs, for each case of `cases`:
    "stacked" and "list" (the MLP stages stacked or as a list, loss sum(y^2)),
    "tree" (`pair_body`'s tree carry over (xs, xs / 2), loss sum(a^2) + 0.5
    sum(b^2)),
    "frozen" (the list with stage 1's leaves not requiring grad),
    "frozen_first" (the list with stage 0's leaves and the microbatches not
    requiring grad, so that rank 0 holds nothing that does), "pre" (the
    microbatches made on every rank as tanh(x @ w0) from a leaf w0). `stages_np`
    a list of {"w1", "w2"} numpy stages, `xs_np` the microbatches (n_micro, mb,
    d), `pre_np` w0 (d, d). -> per case: each stage's gradient (None where
    this rank got none), the microbatches' gradient, and w0's for "pre"."""
    from dg_sct_tpu_torch.parallel import pipeline as PP

    results = []
    for case in cases:
        frozen = {"frozen": 1, "frozen_first": 0}.get(case)
        stages = [{k: torch.tensor(v, requires_grad=i != frozen) for k, v in st.items()}
                  for i, st in enumerate(stages_np)]
        xs = torch.tensor(xs_np, requires_grad=case != "frozen_first")
        w0 = torch.tensor(pre_np, requires_grad=True)
        if case == "tree":
            mbs = [xs, torch.tensor(0.5 * xs_np, requires_grad=True)]
            ya, yb = PP.gpipe(pair_body, stages, mbs, None)
            loss = (ya ** 2).sum() + 0.5 * (yb ** 2).sum()
        else:
            arg = PP.stack_stages(stages) if case == "stacked" else stages
            mb = torch.tanh(xs @ w0) if case == "pre" else xs
            loss = (PP.gpipe(mlp_body, arg, mb, None) ** 2).sum()
        loss.backward()
        out = {"stages": [{k: t.grad for k, t in st.items()} for st in stages],
               "xs": xs.grad, "loss": float(loss.detach())}
        if case == "tree":
            out["xs_b"] = mbs[1].grad
        if case == "pre":
            out["w0"] = w0.grad
        results.append(out)
    return results


def ave_pipe_grad(rank, world, pcfg, jp, js, wave, images, n_micro, weights):
    """The port's pipelined AVE eval forward over a 1-D pipe of the world,
    differentiated with the kernels off: every floating param leaf requires
    grad, the loss is sum(weights[k] * outputs[k]) over the keys of
    `weights`. -> the loss, each leaf's gradient by path (None where this
    rank got none), the pipelined stages, and the error the same forward
    raised with the kernels on."""
    from dg_sct_tpu_torch.models import ave
    from dg_sct_tpu_torch.parallel import mesh
    from dg_sct_tpu_torch.utils.tree import tree_paths
    from dg_sct_tpu_torch.weights import from_jax

    pp, ps = from_jax(jp, js, pcfg, device="cpu")
    leaves = [(p, t.requires_grad_()) for p, t in tree_paths(pp) if t.is_floating_point()]
    m = mesh.make_mesh(world, mesh.PIPE_AXIS)
    run = lambda kernels: ave.forward(pp, ps, wave, images, pcfg, kernels=kernels, device="cpu",
                                      pipeline=(m.group(mesh.PIPE_AXIS), n_micro))
    out = run(False)
    loss = sum((torch.as_tensor(w) * out[k]).sum() for k, w in weights.items())
    loss.backward()
    res = {"loss": float(loss.detach()), "pipelined": list(out["pipelined_stages"]),
           "grads": {"/".join(map(str, p)): t.grad for p, t in leaves}}
    try:
        run(True)
        res["kernels_error"] = None
    except RuntimeError as e:
        res["kernels_error"] = str(e)
    return res
