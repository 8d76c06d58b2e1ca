"""K3's float32 entry on the card (`csrc/adapter_bottleneck.cu` `launch_f32`)
refuses a shape when no launch plan fits in shared memory. This file mirrors
that rule in Python (`f32_geometry`, `f32_plan`: the same integer arithmetic as
`launch_f32` and `make_tf32_plan`, for an H100's 132 SMs and 227 KB of shared
memory a block) and holds it over every K3 shape the port's configurations
produce: the AVE and AVVP adapters, AVQA's four groups, the pretrain model's
ViT and HTS-AT adapters, at the row counts of one clip up to eight, of a
sequence-parallel rank (half the frames) and of a tensor-parallel rank at
model 4 (whole adapters, every row), and chip_smoke.py's K3_EXTRA. So no
float32 path raises on the card for a shape the scalar kernel it replaced
took; what it refuses of the rest of that kernel's range is pinned below. A
change to the C++ rule must change the mirror with it.""" 
import importlib.util
from pathlib import Path

import pytest

from dg_sct_tpu_torch import configs as PC

SMS, SMEM_MAX = 132, 232448  # H100: SMs; opt-in shared memory a block, bytes
WARPS, DEPTH, ROWS = 8, 4, 16  # kWarps, kF32Depth, rows an m-tile
SERIAL_STEPS = 16  # kSerialSteps
TILE_COUNTS = (1, 2, 3, 6, 12)  # kTileCounts
SLOTS = (1024, 768, 512, 384, 256, 128)


def ceil_div(a, b):
    return (a + b - 1) // b


def round_up(a, b):
    return ceil_div(a, b) * b


def spread(n):
    return n if n % 32 in (8, 24) else n + 8


def tile_count(n, nt_max):
    for t in TILE_COUNTS:
        if t >= n:
            return min(t, nt_max)
    return nt_max


def tile_count_below(n):
    return max([t for t in TILE_COUNTS if t < n], default=1)


def smem_bytes(p, m):
    return 4 * (ROWS * m * (p["ost"] + 2 * p["gl"] * p["hst"] + 2) + p["nvec"]
                + WARPS * DEPTH * p["slot"])


def f32_plan(C, G, go, cl_ctas, m, slot, budget):
    """make_tf32_plan: the plan's fields, or None where it does not fit."""
    nt_max = 12 // m
    gi = C // G
    gl = G // cl_ctas
    p = dict(gl=gl, cl=gl * gi, gik=round_up(gi, 8), gok=round_up(go, 8), slot=slot)
    p["ost"] = round_up(p["cl"] + p["gik"] - gi, 8) + 4
    p["hst"] = p["gok"] + 4
    p["nvec"] = round_up(5 * p["cl"] + gl * p["gok"], 4)
    wpg = WARPS // gl if gl <= WARPS else 1
    ntd = p["gok"] // 8
    kss = wpg if p["gik"] // 8 > SERIAL_STEPS else 1
    while kss > 1:
        tpw = ceil_div(ntd, wpg // kss)
        if (wpg % kss == 0 and tpw <= nt_max and kss * gl * p["gok"] <= p["ost"]
                and 8 * spread(8 * tile_count(tpw, nt_max)) <= slot):
            break
        kss -= 1
    tpw = ceil_div(ntd, wpg // kss)
    dw = 8 * tile_count(tpw, nt_max)
    while dw > 8 and 8 * spread(dw) > slot:
        dw = 8 * tile_count_below(dw // 8)
    kcd = min(p["gik"] // 8, slot // (8 * spread(dw)))
    uw = 8 * tile_count(min(ceil_div(p["cl"], 8 * WARPS), p["gik"] // 8), nt_max)
    while uw > 8 and 8 * spread(uw) > slot:
        uw = 8 * tile_count_below(uw // 8)
    kcu = min(ntd, slot // (8 * spread(uw)))
    if kcd < 1 or kcu < 1 or smem_bytes(p, m) > budget:
        return None
    return dict(p, kss=kss, dw=dw, uw=uw)


def f32_geometry(rows, C, G, go):
    """launch_f32 with the geometry left to it: (cluster, m, plan), or None
    where it returns cudaErrorInvalidValue."""
    if G < 1 or go < 1 or C < G or C % G or rows < 1:
        return None
    cluster = 2 if G % 2 == 0 and ceil_div(rows, 16) < SMS else 1
    m = 2 if 5 * ceil_div(rows, 32) * cluster >= 3 * SMS else 1
    if cluster == 1 and C <= 192 and ceil_div(rows, 64) >= 2 * SMS:
        m = 4
    half = SMEM_MAX // 2 - 1024
    for cl in (cluster, 3 - cluster):
        if G % cl:
            continue
        for mm in (4, 2, 1):
            if mm > m or (mm == 4 and cl == 2):
                continue
            two = ceil_div(rows, 16 * mm) * cl > SMS
            for budget in (half if two else SMEM_MAX, SMEM_MAX):
                for slot in SLOTS:
                    plan = f32_plan(C, G, go, cl, mm, slot, budget)
                    if plan is not None:
                        return cl, mm, plan
    return None


def scalar_kernel_took(C, G, go):
    """What the scalar float32 kernel it replaced accepted: C a multiple of G
    and its 16 x (C + G go) float32 tile in shared memory."""
    return G >= 1 and go >= 1 and C % G == 0 and 4 * 16 * (C + G * go) <= SMEM_MAX


def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_k3_shapes", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def adapter_shapes():
    """{(C, G, go): [tokens a frame, ...]} of every adapter that takes K3, with
    the frames a clip (num_frames) of its model."""
    out = {}

    def add(dim, tokens, acfg, frames):
        go = dim // acfg.reduction_factor // acfg.num_conv_group
        out.setdefault((dim, acfg.num_conv_group, go, frames), set()).add(tokens)

    for cfg in (PC.AVEModelConfig(), PC.AVVPModelConfig(), PC.AVQAModelConfig()):
        vis = PC.vis_adapter_cfg(cfg)
        for v_dim, v_tok, a_dim, a_tok in PC.ave_adapter_dims(cfg.swin, cfg.htsat):
            add(v_dim, v_tok, vis, cfg.num_frames)
            add(a_dim, a_tok, cfg.adapter, cfg.num_frames)
    cfg = PC.PretrainModelConfig()
    add(cfg.clip.vision_width, (cfg.clip.image_size // cfg.clip.vision_patch) ** 2 + 1,
        cfg.adapter, cfg.num_frames)
    for s in range(len(cfg.htsat.depths)):
        res = cfg.htsat.stage_resolution(s)
        add(cfg.htsat.stage_dim(s), res[0] * res[1], cfg.adapter, cfg.num_frames)
    return out


def port_cases():
    """(rows, C, G, go) of every K3 call the port's configurations make at
    1 to 8 clips a batch, a sequence-parallel rank's half of the frames, and
    chip_smoke.py's K3_EXTRA."""
    cases = set()
    for (C, G, go, frames), tokens in adapter_shapes().items():
        for n in tokens:
            for clips in (1, 2, 3, 4, 8):
                for f in (frames, frames // 2):
                    cases.add((clips * f * n, C, G, go))
    for rows, C, G, go, _ in _chip_smoke().K3_EXTRA:
        cases.add((rows, C, G, go))
    return sorted(cases)


def test_the_shapes_cover_the_port():
    """The walk finds the main path's shapes: phase 3's AVE, AVQA and
    pretrain cases are among them."""
    smoke = _chip_smoke()
    cases = set(port_cases())
    from dg_sct_tpu_torch.configs import AVEModelConfig
    want = [key for name, key, _ in smoke.kernel_cases(AVEModelConfig())
            if name == "adapter_bottleneck"]
    want += list(smoke.avqa_k3_cases()) + [smoke.pretrain_k3_case()[0]]
    assert {k[:4] for k in want} <= cases


@pytest.mark.parametrize("case", port_cases(), ids=lambda c: "-".join(map(str, c)))
def test_f32_entry_takes_every_port_shape(case):
    rows, C, G, go = case
    assert scalar_kernel_took(C, G, go)
    got = f32_geometry(rows, C, G, go)
    assert got is not None, case
    cluster, m, plan = got
    assert smem_bytes(plan, m) <= SMEM_MAX


def scalar_sweep():
    """(C, G, go) the scalar kernel took: G in 1..8, C a multiple of 8 G up to
    4096, go = C / (G r) for reduction factors r of 1 to 32 (the port's
    adapters use 8)."""
    for G in range(1, 9):
        for C in range(8 * G, 4097, 8 * G):
            for r in (1, 2, 4, 8, 16, 32):
                go = C // (G * r)
                if go >= 1 and scalar_kernel_took(C, G, go):
                    yield C, G, go


@pytest.mark.parametrize("rows", [16, 40000])
def test_f32_entry_refuses_only_far_past_the_port(rows):
    """Of what the scalar kernel took, the new rule refuses only shapes of an
    odd number of groups at C of 1000 or more (one CTA holds every channel:
    the x / o tile, h in its TF32 halves, the vectors and the warps' rings
    outgrow 227 KB); an even number of groups goes on a cluster of two. The
    port's adapters have two or four groups."""
    refused = [(C, G, go) for C, G, go in scalar_sweep() if f32_geometry(rows, C, G, go) is None]
    assert all(G % 2 and C >= 1000 for C, G, go in refused), refused[:20]
