"""The harness's counters against the program's own arithmetic: the
frozen attention + MLP count against utils/flops.py, the mfu count
against a hand count, K3's bound against the kernel table's numbers and
its calls against the program's at the reduced rows of input
downsampling, and the downsampling's work against a count of the plain
version's operations."""
from __future__ import annotations

import pytest

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench.lib import counters, program, scenes
from perfbench.reference import downsample as ref_ds
from perfbench.reference.steps import backbone_kwargs, head_channels
from perfbench.tests.tiny import tiny_cell
from splatformer_tpu_torch.configs import load_config
from splatformer_tpu_torch.kernels import attention as port_attention
from splatformer_tpu_torch.utils import flops as port_flops

# the kernel table's per-forward bounds (PERF.md; chip_smoke.py's k3 and
# k3_bwd lines): ms, f32 and bf16, forward and backward
K3_TABLE_MS = {(False, False): 5.79, (False, True): 14.47,
               (True, False): 3.18, (True, True): 3.22}
K3_CLASSES = {"enc0": (98, 2, 32, 2), "enc1_dec1_dec0": (98, 4, 24, 6),
              "enc2_dec2": (74, 8, 16, 4), "enc3_dec3": (47, 16, 16, 8),
              "enc4": (24, 32, 16, 2)}
STAGES = {"enc0": 100000.0, "enc1": 71234.0, "enc2": 40321.0,
          "enc3": 19876.0, "enc4": 8123.0, "dec0": 100000.0,
          "dec1": 71234.0, "dec2": 40321.0, "dec3": 19876.0}


def base_flash():
    return tiny_cell("serve_flash")


@pytest.mark.parametrize("model", ["ptv3_base", "ptv3_tome", "ptv3_pitome",
                                   "ptv3_algm"])
@pytest.mark.parametrize("flash", [False, True])
def test_attention_mlp_count_equals_the_programs(model, flash):
    cfg = load_config("model", model)
    cfg.backbone.enable_flash = flash
    bk = cfg.backbone.backbone_kwargs()
    info = cfg.additional_info
    assert counters.ptv3_attention_mlp_gflops(bk, STAGES, info) == \
        port_flops.ptv3_attention_mlp_gflops(bk, STAGES, info)


def test_k3_calls_are_the_kernel_tables_classes():
    cfg = load_config("model", "ptv3_base")
    cfg.backbone.enable_flash = True
    calls = counters.k3_calls(cfg.backbone.backbone_kwargs(), 100352)
    want = []
    for b, h, d, blocks in K3_CLASSES.values():
        want += [(b, h, d, 1024)] * blocks
    assert sorted(calls) == sorted(want) and len(calls) == 22


@pytest.mark.parametrize("bf16,backward", list(K3_TABLE_MS))
def test_k3_bound_reproduces_the_kernel_table(bf16, backward):
    ops = sum(blocks * counters.k3_bound(b, h, d, bf16, backward, 1024)[0]
              for b, h, d, blocks in K3_CLASSES.values())
    nbytes = sum(blocks * counters.k3_bound(b, h, d, bf16, backward, 1024)[1]
                 for b, h, d, blocks in K3_CLASSES.values())
    assert round(max(ops, nbytes) * 1e3, 2) == K3_TABLE_MS[(bf16, backward)]
    # every call is bound by its operations, so the per-call sum the
    # roofline metrics use is the table's number too
    cfg = load_config("model", "ptv3_base")
    cfg.backbone.enable_flash = True
    per_call = counters.k3_forward_bound_s(cfg.backbone.backbone_kwargs(),
                                           100352, bf16, backward)
    assert round(per_call * 1e3, 2) == K3_TABLE_MS[(bf16, backward)]


def hand_count(points, pairs, tokens_mlp, live):
    """The tiny configuration's forward FLOPs counted by hand, two a
    multiply-add: 3 encoder stages of one block (32, 48, 64 channels, 2
    heads, patch 128) and 2 decoder stages of one block (32, 48), each
    block qkv + proj (4 n c^2), the xCPE convolution (pairs c^2) and Linear
    (n c^2), the MLP (2 n c 4c) and the two attention products; the
    embedding (23 inputs), two poolings, two unpoolings (projection and
    skip), and six heads of 4 layers of width 128 on 32 + 23 inputs, at
    the scene's ``live`` points."""
    enc, dec = [32, 48, 64], [32, 48, 64]
    blocks = [(0, 32), (1, 48), (2, 64), (0, 32), (1, 48)]
    dense = attn = 0.0
    for s, c in blocks:
        n = points[s]
        dense += 2 * (4 * n * c * c + pairs[s] * c * c + n * c * c
                      + 2 * tokens_mlp(n) * c * 4 * c)
        attn += 2 * 2 * max(1.0, n / 128) * 2 * 128 * 128 * (c // 2)
    in_ch = 3 + 3 + 1 + 4 + 3 + 9
    outside = 2 * points[0] * in_ch * 32
    outside += 2 * (points[0] * 32 * 48 + points[1] * 48 * 64)
    outside += 2 * (points[1] * 48 * 32 + points[0] * 32 * 32)
    outside += 2 * (points[2] * 64 * 48 + points[1] * 48 * 48)
    head_in = 32 + in_ch
    for out in (3, 3, 1, 4, 3, 9):
        outside += 2 * live * (head_in * 128 + 2 * 128 * 128 + 128 * out)
    return {"block_dense": dense, "outside_dense": outside,
            "attn_products": attn}


def test_mfu_count_equals_a_hand_count():
    model = base_flash()["config"]["model"]
    bk = backbone_kwargs(model["backbone"])
    points = [2000.0, 1300.0, 700.0]
    pairs = [9000.0, 5000.0, 2500.0]
    sp = {"enc0": 2000.0, "enc1": 1300.0, "enc2": 700.0, "dec0": 2000.0,
          "dec1": 1300.0}
    got = counters.model_flops(bk, head_channels(model), sp, pairs,
                               model["additional_info"], live=2000.0)
    assert got == pytest.approx(hand_count(points, pairs, lambda n: n,
                                           live=2000.0), rel=1e-12)


def test_mfu_count_doubles_the_attention_and_mlp_count():
    """Without the terms it adds (xCPE, the embedding, pooling, heads), the
    mfu count is twice the gflops.csv count."""
    model = base_flash()["config"]["model"]
    bk = backbone_kwargs(model["backbone"])
    sp = {"enc0": 2000.0, "enc1": 1300.0, "enc2": 700.0, "dec0": 2000.0,
          "dec1": 1300.0}
    got = counters.model_flops(bk, head_channels(model), sp, [0.0] * 3,
                               model["additional_info"], live=2000.0)
    xcpe_linear = 2 * sum(sp[k] * c * c for k, c in (
        ("enc0", 32), ("enc1", 48), ("enc2", 64), ("dec0", 32),
        ("dec1", 48)))
    attn, mlp = counters.ptv3_attention_mlp_gflops(
        bk, sp, model["additional_info"])
    assert got["block_dense"] + got["attn_products"] - xcpe_linear == \
        pytest.approx(2e9 * (attn + mlp), rel=1e-12)


def test_lpips_count():
    # VGG16 at 64 x 64: the 13 convolutions' multiply-adds, doubled
    want, cin, hw = 0, 3, 64
    for ch, convs in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(convs):
            want += hw * hw * 9 * cin * ch
            cin = ch
        hw //= 2
    assert counters.lpips_flops(1, 64, 64) == 2 * want


def test_mfu_count_takes_the_heads_at_the_live_points():
    """With input downsampling the blocks run on the reduced set and the
    heads on every live point of the scene."""
    model = base_flash()["config"]["model"]
    bk = backbone_kwargs(model["backbone"])
    points = [700.0, 450.0, 260.0]
    pairs = [3000.0, 1800.0, 900.0]
    sp = {"enc0": 700.0, "enc1": 450.0, "enc2": 260.0, "dec0": 700.0,
          "dec1": 450.0}
    got = counters.model_flops(bk, head_channels(model), sp, pairs,
                               model["additional_info"], live=2000.0)
    assert got == pytest.approx(hand_count(points, pairs, lambda n: n,
                                           live=2000.0), rel=1e-12)


@pytest.mark.parametrize("info,rows", [
    ({}, 100352),
    ({"downsample": "fps", "downsample_ratio": 0.35}, 35200),
    ({"downsample": "random", "downsample_ratio": 0.6}, 60288),
    ({"downsample": "voxel", "voxel_size": 0.0075}, 50176)])
def test_backbone_rows_follow_the_configuration(info, rows):
    assert counters.backbone_rows(info, 100352) == rows


def test_k3_calls_at_the_reduced_rows_equal_the_programs_launches(
        monkeypatch):
    """The attention shapes a tiny fps forward with K3 launches (its plain
    version on the CPU) are k3_calls at the reduced rows."""
    cell = tiny_cell("serve_flash")
    model = cell["config"]["model"]
    model["additional_info"].update(downsample="fps", downsample_ratio=0.35)
    pad = cell["config"]["scene"]["pad_to"]
    seen = []
    fwd = port_attention.attention_fwd

    def spy(q, k, v, scale):
        seen.append(tuple(q.shape))
        return fwd(q, k, v, scale)
    monkeypatch.setattr(port_attention, "attention_fwd", spy)
    rng = np.random.default_rng(4)
    scene = scenes.to_device(scenes.random_scene(rng, pad, 1, 1800), "cpu")
    net = program.build_model(model, "cpu")
    with torch.inference_mode():
        net(program.scene(scene))
    bk = backbone_kwargs(model["backbone"])
    rows = counters.backbone_rows(model["additional_info"], pad)
    assert rows == ref_ds.fps_capacity(pad, 0.35) < pad
    # the decoder runs its stages deepest first; k3_calls lists them in
    # block order
    assert sorted(seen) == sorted((b, h, k, d) for b, h, d, k in
                                  counters.k3_calls(bk, rows))


class OpCount(TorchDispatchMode):
    """FP32 operations of the elementwise arithmetic, reductions, argmax
    and argmin and matrix products that run under it: an output element
    of an elementwise op is one, a sum over k elements k - 1 a result, an
    argmax or argmin over k elements k a result (comparisons), a product
    two a multiply-add."""

    ELEMENTWISE = {"sub", "mul", "add", "rsub", "pow", "minimum"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        x = args[0]
        if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
            if name in self.ELEMENTWISE:
                self.ops += (kwargs or {}).get("out", out).numel()
            elif name == "sum":
                self.ops += x.numel() - out.numel()
            elif name in ("argmax", "argmin"):
                self.ops += x.numel()
            elif name == "mm":
                self.ops += 2 * x.shape[0] * x.shape[1] * args[1].shape[1]
        return out


@pytest.mark.parametrize("n,m", [(37, 5), (300, 20)])
def test_downsampling_work_equals_a_count_of_the_plain_version(n, m):
    """fps_work and nearest_work against the operations the plain version
    runs, counted op by op, and against their bytes counted by hand:
    inputs read once, outputs written once."""
    rng = np.random.default_rng(n)
    coord = torch.as_tensor(rng.uniform(size=(n, 3)), dtype=torch.float32)
    mask = torch.ones(n, dtype=torch.bool)
    with OpCount() as c:
        picks = ref_ds.furthest_point_sampling(coord, mask, m)
    ops, nbytes = counters.fps_work(n, m)
    assert c.ops == ops
    assert nbytes == coord.numel() * 4 + mask.numel() + picks.numel() * 8
    refs = coord.index_select(0, picks)
    ref_mask = torch.ones(m, dtype=torch.bool)
    with OpCount() as c:
        idx = ref_ds.nearest_idx(coord, refs, ref_mask)
    ops, nbytes = counters.nearest_work(n, m)
    assert c.ops == ops
    assert nbytes == (coord.numel() * 4 + refs.numel() * 4 + m
                      + idx.numel() * 8)
    assert counters.fps_bound_s(n, m) == max(
        counters.fps_work(n, m)[0] / counters.PEAK_F32,
        counters.fps_work(n, m)[1] / counters.PEAK_BYTES)
    # at the fps cell's size both are bound by their operations
    assert counters.fps_bound_s(100352, 35123) == pytest.approx(
        10 * 100352 * 35123 / 67e12)
    assert counters.nearest_bound_s(100352, 35200) == pytest.approx(
        (11 * 100352 * 35200 + 5 * (100352 + 35200)) / 67e12)


def test_k3_bound_counts_the_patch_it_is_given():
    """A call over patches of 128 tokens: 64 times fewer pairs a patch than
    1024, so at the same rows 8 times fewer in all."""
    cfg = load_config("model", "ptv3_base")
    cfg.backbone.enable_flash = True
    cfg.backbone.patch_size = 128
    bk = cfg.backbone.backbone_kwargs()
    calls = counters.k3_calls(bk, 35200)
    assert calls[0] == (275, 2, 32, 128)
    one = counters.k3_bound(275, 2, 32, False, False, 128)
    assert one[3] == 275 * 2 * 128 * 128
    assert counters.k3_forward_bound_s(bk, 35200, False, False) == sum(
        max(counters.k3_bound(b, h, d, False, False, k)[:2])
        for b, h, d, k in calls)
