"""The port's conv-network slice against the JAX package, on the CPU.

The same numpy-seeded images and weights go through a ``tpu_dist_nn``
function and its ``tpu_dist_nn_torch`` counterpart in this process. The
JAX ``fused_conv2d`` runs its Pallas kernel in interpret mode, as
``tests/test_conv_kernel.py`` runs it; the port's wrapper runs its plain
version for CPU tensors. Tolerances are those of the JAX package's own
tests: rtol 2e-5 / atol 1e-5 for the kernel (``test_conv_kernel.py``),
rtol 2e-4 / atol 1e-5 for the network against the float64 oracle, and
rtol 5e-4 / atol 1e-5 for the engine (``test_conv.py``). Images stay
small because interpret-mode Pallas is slow. The conv kernel itself runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); its
schedule (the planner's tiles, the patch each K slice gathers with its
zero fill, each thread's pixels and channel group, the conv tile and the
pool over it) is written out in numpy here and held against both.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_dist_nn.models.network as jax_network
from tpu_dist_nn.api.engine import Engine as JaxEngine
from tpu_dist_nn.cli import main as tdn_main
from tpu_dist_nn.core import schema as jax_schema
from tpu_dist_nn.core.activations import ACTIVATION_NAMES, activation_id
from tpu_dist_nn.kernels.conv2d import fused_conv2d as jax_fused_conv2d
from tpu_dist_nn.testing import oracle as jax_oracle
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main as port_main
from tpu_dist_nn_torch.core.activations import SOFTMAX_ID, apply_activation_by_id
from tpu_dist_nn_torch.core import schema as pt_schema
from tpu_dist_nn_torch.kernels import (
    KERNEL_WRAPPERS,
    fused_conv2d,
    fused_conv2d_plain,
    reset_launch_counts,
)
from tpu_dist_nn_torch.kernels.conv2d import SMEM_LIMIT_BYTES, conv_args, conv_plan, same_pad
from tpu_dist_nn_torch.models import network
from tpu_dist_nn_torch.testing import oracle
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ACTIVATIONS = ["linear", "relu", "sigmoid", "tanh", "gelu", "softmax"]


def _jax_conv_mlp(seed=0, **kw):
    kw = {"in_shape": (8, 8, 3), "conv_filters": (4, 8), "hidden": (16,),
          "num_classes": 4, **kw}
    return jax_network.init_conv_mlp(jax.random.key(seed), **kw)


@pytest.fixture
def conv_file(tmp_path):
    """A tiny conv-pool-conv-pool-dense-dense model with nonzero biases,
    written by the JAX package in the public JSON schema."""
    model = _jax_conv_mlp()
    rng = np.random.default_rng(9)
    for layer in model.layers:
        if layer.kind != "maxpool2d":
            layer.biases = rng.normal(0.0, 0.05, layer.biases.shape)
    path = tmp_path / "conv.json"
    jax_schema.save_model(model, path)
    return path


def _imgs(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# --------------------------------------------------------------- schema


def test_conv_json_round_trips_between_the_packages(conv_file, tmp_path):
    model = pt_schema.load_model(conv_file)
    jmodel = jax_schema.load_model(conv_file)
    assert [l.kind for l in model.layers] == [l.kind for l in jmodel.layers] == [
        "conv2d", "maxpool2d", "conv2d", "maxpool2d", "dense", "dense"]
    assert not model.is_dense and model.input_dim == 192 and model.output_dim == 4
    assert model.layer_sizes == jmodel.layer_sizes
    assert model.to_json_dict() == jmodel.to_json_dict()
    back = tmp_path / "back.json"
    pt_schema.save_model(model, back)
    assert jax_schema.load_model(back).to_json_dict() == jmodel.to_json_dict()
    pool = pt_schema.MaxPool2DSpec(in_shape=(8, 8, 4), window=(3, 3), stride=(2, 2))
    assert pool.to_json() == jax_schema.MaxPool2DSpec((8, 8, 4), (3, 3), (2, 2)).to_json()
    assert pt_schema.MaxPool2DSpec.from_json(pool.to_json()).out_shape == (3, 3, 4)
    stages = pt_schema.partition_model(model, [2, 2, 2])
    assert [s.expected_input_dim for s in stages] == [
        s.expected_input_dim for s in jax_schema.partition_model(jmodel, [2, 2, 2])]


@pytest.mark.parametrize(
    "in_shape,k,stride,padding",
    [((7, 7, 2), 3, (2, 2), "valid"), ((7, 6, 2), 3, (2, 3), "same"),
     ((8, 8, 2), 2, (1, 1), "same"), ((9, 5, 2), 4, (3, 1), "valid")],
)
def test_conv_spec_shapes_match_jax(in_shape, k, stride, padding):
    w = np.zeros((k, k, in_shape[2], 5))
    spec = pt_schema.Conv2DSpec(in_shape, w, np.zeros(5), stride, padding)
    jspec = jax_schema.Conv2DSpec(in_shape, w, np.zeros(5), stride, padding)
    assert (spec.out_shape, spec.in_dim, spec.out_dim) == (
        jspec.out_shape, jspec.in_dim, jspec.out_dim)
    assert spec.to_json() == jspec.to_json()


_BAD_LAYERS = {
    "channels": {"type": "conv2d", "in_shape": [4, 4, 3],
                 "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 4},
    "padding": {"type": "conv2d", "in_shape": [4, 4, 2], "padding": "reflect",
                "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 4},
    "bias": {"type": "conv2d", "in_shape": [4, 4, 2],
             "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 3},
    "does not fit": {"type": "conv2d", "in_shape": [2, 2, 2], "padding": "valid",
                     "weights": np.zeros((3, 3, 2, 4)).tolist(), "bias": [0.0] * 4},
    "must be positive": {"type": "maxpool2d", "in_shape": [4, 4, 2], "window": [0, 2]},
    "does not fit input": {"type": "maxpool2d", "in_shape": [4, 4, 2], "window": [5, 2]},
}


@pytest.mark.parametrize("match", sorted(_BAD_LAYERS))
def test_conv_validation_errors_match_jax(match):
    obj = {"layers": [_BAD_LAYERS[match]]}
    with pytest.raises(ValueError, match=match) as want:
        jax_schema.ModelSpec.from_json_dict(obj)
    with pytest.raises(ValueError, match=match) as got:
        pt_schema.ModelSpec.from_json_dict(obj)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------- oracle


@pytest.mark.parametrize("conv_act", ["relu", "softmax", "TanH", "unknown"])
def test_oracle_matches_the_jax_oracle_exactly(conv_file, conv_act):
    obj = json.loads(conv_file.read_text())
    obj["layers"][2]["activation"] = conv_act  # the second conv
    # A SAME 2x2 conv that keeps the 4x4x4 shape: even kernel, so the
    # extra padding row and column go after.
    obj["layers"].insert(2, {
        "type": "conv2d", "in_shape": [4, 4, 4], "stride": [1, 1], "padding": "same",
        "weights": (np.random.default_rng(3).normal(size=(2, 2, 4, 4)) * 0.3).tolist(),
        "bias": [0.1, -0.1, 0.0, 0.2], "activation": "sigmoid"})
    model = pt_schema.ModelSpec.from_json_dict(obj)
    jmodel = jax_schema.ModelSpec.from_json_dict(obj)
    x = np.random.default_rng(1).uniform(size=(4, model.input_dim))
    want = jax_oracle.oracle_forward_batch(jmodel, x)
    np.testing.assert_array_equal(oracle.oracle_forward_batch(model, x), want)
    for size, k, s in [(32, 3, 1), (16, 2, 1), (9, 4, 2), (7, 3, 3), (5, 1, 2)]:
        assert oracle._same_pad(size, k, s) == jax_oracle._same_pad(size, k, s)
        assert same_pad(size, k, s) == jax_oracle._same_pad(size, k, s)
    with pytest.raises(ValueError, match="Dimension mismatch"):
        oracle.oracle_forward(model, x[0, :-1])


# ------------------------------------------------- kernel (plain version)


_KERNEL_CASES = {
    **{f"{pad}-s{s}": dict(padding=pad, stride=(s, s), activation="relu")
       for pad in ("valid", "same") for s in (1, 2)},
    "pool2x2": dict(padding="valid", activation="relu", pool_window=(2, 2)),
    "same-pool2x2": dict(padding="same", activation="tanh", pool_window=(2, 2)),
    "pool3x3s2": dict(padding="valid", activation="relu", pool_window=(3, 3),
                      pool_stride=(2, 2)),
    "pool3x3s1": dict(padding="same", activation="linear", pool_window=(3, 3),
                      pool_stride=(1, 1)),
    "k2-same": dict(padding="same", activation="sigmoid", k=2),
    "k4-same": dict(padding="same", activation="gelu", k=4),
    **{f"act-{a}": dict(padding="same", activation=a, pool_window=(2, 2)) for a in ACTIVATIONS},
    "unknown-name": dict(padding="valid", activation="ReLU-Custom"),
    "mixed-case": dict(padding="valid", activation="TanH"),
}


@pytest.mark.parametrize("case", list(_KERNEL_CASES))
def test_plain_conv_matches_the_jax_pallas_kernel(case):
    kw = dict(_KERNEL_CASES[case])
    k = kw.pop("k", 3)
    rng = np.random.default_rng(0)
    imgs = _imgs((5, 9, 9, 3))
    w = (rng.normal(size=(k, k, 3, 7)) * 0.3).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    # The JAX network canonicalises the name before its Pallas call
    # (models/network.py:131-135); the port's wrapper does it itself.
    jax_kw = dict(kw, activation=ACTIVATION_NAMES[activation_id(kw["activation"])])
    want = np.asarray(jax_fused_conv2d(jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(b),
                                       **jax_kw))
    reset_launch_counts()
    got = fused_conv2d(torch.from_numpy(imgs), torch.from_numpy(w), torch.from_numpy(b), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    assert fused_conv2d.launches == 0  # a CPU tensor runs the plain version


def test_conv_wrapper_validates_like_the_jax_kernel():
    imgs, w, b = torch.zeros(2, 5, 5, 3), torch.zeros(3, 3, 4, 6), torch.zeros(6)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_fused_conv2d(jnp.zeros((2, 5, 5, 3)), jnp.zeros((3, 3, 4, 6)), jnp.zeros(6))
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fused_conv2d(imgs, w, b)
    w = torch.zeros(3, 3, 3, 6)
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fused_conv2d(imgs, w, torch.zeros(5))
    with pytest.raises(InvalidArgumentError, match="dtype"):
        fused_conv2d(imgs.double(), w, b)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        fused_conv2d(imgs.transpose(1, 2), w, b)
    with pytest.raises(InvalidArgumentError, match="padding"):
        fused_conv2d(imgs, w, b, padding="reflect")
    with pytest.raises(InvalidArgumentError, match="do not fit"):
        fused_conv2d(imgs, w, b, pool_window=(4, 4))


def test_conv_plan_bands_and_shared_memory_limit():
    stage1 = conv_plan((1024, 32, 32, 3), (3, 3, 3, 16), (1, 1), "same", (2, 2))
    stage2 = conv_plan((1024, 16, 16, 16), (3, 3, 16, 32), (1, 1), "same", (2, 2))
    # Stage 1: a CTA computes one image (1024 conv pixels x 16 channels);
    # stage 2: two images (512 x 32). Both pool relu 2x2 in registers;
    # each layer's input channels fit one K slice.
    assert stage1.out_shape == (1024, 16, 16, 16) and stage2.out_shape == (1024, 8, 8, 32)
    assert (stage1.cg, stage1.imgs, stage1.tile, stage1.conv_tile) == (1, 1, (16, 16), (32, 32))
    assert (stage2.cg, stage2.imgs, stage2.tile, stage2.conv_tile) == (2, 2, (8, 8), (16, 16))
    assert stage1.grid == (1024, 1, 1, 1) and stage2.grid == (512, 1, 1, 1)
    assert stage1.pool_regs and stage2.pool_regs
    assert (stage1.slices, stage2.slices, stage2.ck) == (1, 1, 16)
    # Three CTAs an SM by shared memory.
    assert max(stage1.smem_bytes, stage2.smem_bytes) <= 228 * 1024 // 3
    assert stage1.pad == (1, 1) and stage1.pool == (2, 2, 2, 2)
    strided = conv_plan((2, 9, 9, 3), (4, 4, 3, 5), (2, 2), "same")
    assert strided.pad == (same_pad(9, 4, 2)[0],) * 2 and strided.conv_hw == (5, 5)
    wide = conv_plan((4, 112, 112, 64), (3, 3, 64, 64), (1, 1), "same")
    assert wide.tile == (4, 112) and wide.grid == (4, 28, 1, 2) and wide.slices == 8
    assert wide.smem_bytes <= SMEM_LIMIT_BYTES
    # The shape the band planner refused (one band row over 227 KB): K
    # now streams 8 input channels a slice (two slots in 113 KB: two CTAs
    # an SM), 32 output channels a CTA.
    big = conv_plan((1, 64, 64, 256), (3, 3, 256, 256), (1, 1), "same")
    assert (big.ck, big.slices, big.grid) == (8, 32, (1, 8, 1, 8))
    assert big.smem_bytes <= SMEM_LIMIT_BYTES
    with pytest.raises(InvalidArgumentError, match="softmax over 200 channels"):
        conv_plan((1, 8, 8, 3), (3, 3, 3, 200), (1, 1), "same", activation="softmax")


def test_cpu_path_has_no_shared_memory_limit():
    # One staged row of 34 x 1025 floats, three rows deep, was over a
    # block's shared memory for the band planner: the implicit GEMM
    # streams the 1024 input channels in 32 slices of 32, so the card
    # plans the layer, and the plain version on the CPU computes it.
    imgs_shape, w_shape = (1, 3, 32, 1024), (3, 3, 1024, 1)
    plan = conv_plan(imgs_shape, w_shape, (1, 1), "same")
    assert (plan.ck, plan.slices, plan.smem_bytes <= SMEM_LIMIT_BYTES) == (32, 32, True)
    rng = np.random.default_rng(9)
    imgs, w = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               for shape in (imgs_shape, w_shape))
    b = torch.zeros(1)
    got = fused_conv2d(imgs, w, b, padding="same", activation="relu")
    want = fused_conv2d_plain(imgs, w, b, padding="same", activation="relu")
    assert got.shape == (1, 3, 32, 1) and torch.equal(got, want)
    # The card's schedule, emulated: 9216-term sums of unit-normal
    # products (outputs up to ~200) in another float32 order, so it and
    # the plain version are each held against float64 at 2e-6 of the
    # largest output.
    emulated = _emulate_conv(imgs.numpy(), w.numpy(), b.numpy(), padding="same",
                             activation="relu")
    ref = torch.relu(torch.nn.functional.conv2d(
        imgs.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1), padding=1)
    ).permute(0, 2, 3, 1).numpy()
    tol = 2e-6 * np.abs(ref).max()
    np.testing.assert_allclose(emulated, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(want.numpy(), ref, rtol=0, atol=tol)


# ---------------------------------------- the conv kernel's schedule, emulated

def _conv_arg_names():
    """csrc/conv2d.cu's ConvArgs field names, in order."""
    src = (ROOT / "tpu_dist_nn_torch/kernels/csrc/conv2d.cu").read_text()
    body = src[src.index("struct ConvArgs {"):].split("};")[0]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip()
        if decl.startswith("int "):
            names += [n.strip() for n in decl[4:].rstrip(";").split(",")]
    return names


def _pixel_slot(a, pwi, lane, p):
    """csrc ``pixel_slot``: the tile pixel a thread's p-th pixel is."""
    if a["pool_regs"] and a["ccw"] == 16:
        return pwi * 128 + (2 * (2 * (p >> 1) + (lane >> 4)) + (p & 1)) * 16 + (lane & 15)
    return pwi * 128 + lane + 32 * p


def _emulate_conv(imgs, w, b, *, stride=(1, 1), padding="valid", activation="linear",
                  pool_window=None, pool_stride=None, gather_shift=0):
    """``csrc/conv2d.cu``'s loop in numpy, from the ``ConvArgs`` the
    wrapper passes: each CTA's tile, its K slices' patch (gathered with
    zero fill at the kernel's offsets; ``gather_shift`` moves the input
    rows a patch reads) and weights, each thread's 4 pixels (offsets
    into the patch) times its channel group's 16 weights per tap and
    input channel; then either the register pool (window partners by
    pixel slot: the thread's next pixel or lane ^ 16 for the row, lane
    ^ 1 for the column; max, then bias and relu) or bias into the conv
    tile, softmax over a pixel's channels, and the pool over it."""
    plan = conv_plan(imgs.shape, w.shape, stride, padding, pool_window, pool_stride, activation)
    a = dict(zip(_conv_arg_names(), conv_args(plan, imgs.shape, w.shape, stride, activation)))
    act = a["act"]
    nct, mt = 16 * a["cg"], 1024 // a["cg"]
    out = np.full(plan.out_shape, np.nan, np.float32)
    per_img = a["cr"] * a["ccw"]
    w_rows = w.reshape(a["kh"] * a["kw"], a["cin"], a["cout"])
    blocks = -(-a["B"] // a["imgs"]) * a["tiles_y"] * a["tiles_x"] * a["ctiles"]
    for bid in range(blocks):
        ct, rest = bid % a["ctiles"], bid // a["ctiles"]
        tx, rest = rest % a["tiles_x"], rest // a["tiles_x"]
        ty, b0 = rest % a["tiles_y"], rest // a["tiles_y"] * a["imgs"]
        c0, py0, px0 = ct * nct, ty * a["tpr"], tx * a["tpc"]
        iy0 = py0 * a["psh"] * a["sh"] - a["pad_t"] + gather_shift
        ix0 = px0 * a["psw"] * a["sw"] - a["pad_l"]
        # Thread (warp pwi * cg + cgi, lane) takes pixels pwi * 128 + lane + 32p.
        m = np.arange(mt)
        mm = np.where(m < a["imgs"] * per_img, m, 0)
        img, rem = mm // per_img, mm % per_img
        poff = img * a["pimg"] + rem // a["ccw"] * a["sh"] * a["prs"] + rem % a["ccw"] * a["sw"] * a["cs"]
        acc = np.zeros((mt, nct), np.float32)
        for s in range(-(-a["cin"] // a["ck"])):
            k0 = s * a["ck"]
            slot = np.zeros(a["stage_floats"], np.float32)
            gi, gr, gc, gk = np.meshgrid(np.arange(a["imgs"]), np.arange(a["prow"]),
                                         np.arange(a["pcol"]), np.arange(a["ck"]), indexing="ij")
            bb, iy, ix, kk = b0 + gi, iy0 + gr, ix0 + gc, k0 + gk
            ok = (bb < a["B"]) & (iy >= 0) & (iy < a["H"]) & (ix >= 0) & (ix < a["W"]) & (kk < a["cin"])
            vals = imgs[np.where(ok, bb, 0), np.where(ok, iy, 0), np.where(ok, ix, 0),
                        np.where(ok, kk, 0)]
            slot[gi * a["pimg"] + gr * a["prs"] + gc * a["cs"] + gk] = np.where(ok, vals, 0.0)
            ws = np.zeros((a["kh"] * a["kw"], a["ck"], nct), np.float32)
            kc = min(a["ck"], a["cin"] - k0)
            nc = min(nct, a["cout"] - c0)
            ws[:, :kc, :nc] = w_rows[:, k0:k0 + kc, c0:c0 + nc]
            for i in range(a["kh"]):
                for j in range(a["kw"]):
                    for ci in range(a["ck"]):
                        av = slot[poff + i * a["prs"] + j * a["cs"] + ci]
                        acc += np.outer(av, ws[i * a["kw"] + j, ci])
        bias = np.zeros(nct, np.float32)
        bias[:min(nct, a["cout"] - c0)] = b[c0:c0 + nct]
        npr, npc = min(a["tpr"], a["ph"] - py0), min(a["tpc"], a["pw"] - px0)
        nc = min(nct, a["cout"] - c0)
        if a["pool_regs"]:
            # Each thread: the max of its pixels p and p + 1 (a window's two
            # rows), then of lane ^ 1's (its two columns); bias and relu
            # after; the lane at the window's top-left stores.
            for pwi in range(mt // 128):
                for p in (0, 2):
                    v = {}
                    for lane in range(32):
                        v[lane] = np.maximum(acc[_pixel_slot(a, pwi, lane, p)],
                                             acc[_pixel_slot(a, pwi, lane, p + 1)])
                    for lane in range(32):
                        y = np.maximum(v[lane], v[lane ^ 1]) + bias
                        if act == activation_id("relu"):
                            y = np.maximum(y, 0.0)
                        im, rem = divmod(_pixel_slot(a, pwi, lane, p), per_img)
                        cy, cx = divmod(rem, a["ccw"])
                        if (cx % 2 or im >= a["imgs"] or b0 + im >= a["B"] or cy // 2 >= npr
                                or cx // 2 >= npc):
                            continue
                        out[b0 + im, py0 + cy // 2, px0 + cx // 2, c0:c0 + nc] = y[:nc]
            continue
        tile = torch.from_numpy(acc + bias)
        if act == SOFTMAX_ID:
            tile[:, :a["cout"]] = torch.softmax(tile[:, :a["cout"]], dim=1)
        else:
            tile = apply_activation_by_id(tile, act)
        tile = tile.numpy()
        for im in range(min(a["imgs"], a["B"] - b0)):
            for pr in range(npr):
                for pc in range(npc):
                    best = np.full(nc, -np.inf, np.float32)
                    for i in range(a["pwh"]):
                        for j in range(a["pww"]):
                            mpix = (im * a["cr"] + pr * a["psh"] + i) * a["ccw"] + pc * a["psw"] + j
                            best = np.maximum(best, tile[mpix, :nc])
                    out[b0 + im, py0 + pr, px0 + pc, c0:c0 + nc] = best
    return out


_SCHEDULE_CASES = {
    # the CIFAR stages' register pools: 32 and 16 columns wide, 1 and 2 images a tile
    "register-pool-wide": ((2, 32, 32, 3), 3, 16, dict(padding="same", activation="relu",
                                                        pool_window=(2, 2))),
    "register-pool-narrow": ((3, 16, 16, 16), 3, 32, dict(padding="same", activation="linear",
                                                           pool_window=(2, 2))),
    # two images in one CTA's tile (144 conv pixels each)
    "images-per-tile": ((2, 12, 12, 3), 3, 16, dict(padding="same", activation="relu",
                                                     pool_window=(2, 2))),
    # 3 row tiles of 7, 7 and 6 pooled rows; 20 channels: 2 groups of 16
    "ragged-row-tiles": ((1, 40, 36, 3), 3, 20, dict(padding="same", activation="relu",
                                                      pool_window=(2, 2))),
    # overlapping 3x3/2 windows: two row tiles share conv rows
    "overlapping-pool": ((1, 70, 30, 2), 3, 8, dict(padding="valid", activation="sigmoid",
                                                     pool_window=(3, 3), pool_stride=(2, 2))),
    "stride2-same": ((2, 19, 17, 3), 4, 5, dict(padding="same", activation="gelu",
                                                 stride=(2, 2))),
    "stride2-valid": ((2, 19, 17, 3), 3, 6, dict(padding="valid", activation="tanh",
                                                  stride=(2, 2), pool_window=(2, 2))),
    # softmax over 40 channels: one CTA holds them all (4 groups)
    "softmax": ((2, 20, 16, 3), 3, 40, dict(padding="same", activation="softmax")),
    # 70 input channels in 2 K slices; 40 output channels in 2 channel tiles
    "k-slices-channel-tiles": ((1, 10, 9, 70), 3, 40, dict(padding="same", activation="linear")),
}


@pytest.mark.parametrize("case", list(_SCHEDULE_CASES))
def test_conv_schedule_emulated_matches_plain_and_jax(case):
    shape, k, cout, kw = _SCHEDULE_CASES[case]
    rng = np.random.default_rng(len(case))
    imgs = rng.uniform(0, 1, shape).astype(np.float32)
    w = rng.normal(0, (2 / (k * k * shape[3])) ** 0.5, (k, k, shape[3], cout)).astype(np.float32)
    b = rng.normal(0, 0.05, cout).astype(np.float32)
    plan = conv_plan(shape, (k, k, shape[3], cout), kw.get("stride", (1, 1)), kw["padding"],
                     kw.get("pool_window"), kw.get("pool_stride"), kw["activation"])
    assert plan.pool_regs == case.startswith("register-pool")
    got = _emulate_conv(imgs, w, b, **kw)
    want = fused_conv2d_plain(torch.from_numpy(imgs), torch.from_numpy(w), torch.from_numpy(b),
                              **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    jax_out = np.asarray(jax_fused_conv2d(jnp.asarray(imgs), jnp.asarray(w), jnp.asarray(b), **kw))
    np.testing.assert_allclose(got, jax_out, rtol=2e-5, atol=1e-5)
    # A patch gathered one input row off is caught.
    shifted = _emulate_conv(imgs, w, b, gather_shift=1, **kw)
    assert not np.allclose(shifted, want, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("stage", ["conv1", "conv2", "conv2-tanh"])
def test_conv_patch_reads_fall_in_distinct_banks(stage):
    # At each of a thread's pixels, a warp's 32 lanes read 32 patch floats
    # (one input channel of one tap); the planner's strides put them in 32
    # banks, so a read is one shared-memory wavefront.
    shape, w_shape, act = {"conv1": ((1024, 32, 32, 3), (3, 3, 3, 16), "relu"),
                           "conv2": ((1024, 16, 16, 16), (3, 3, 16, 32), "relu"),
                           "conv2-tanh": ((1024, 16, 16, 16), (3, 3, 16, 32), "tanh")}[stage]
    plan = conv_plan(shape, w_shape, (1, 1), "same", (2, 2), None, act)
    a = dict(zip(_conv_arg_names(), conv_args(plan, shape, w_shape, (1, 1), act)))
    assert a["pool_regs"] == (act == "relu")
    per_img = a["cr"] * a["ccw"]
    slots = set()
    for pwi in range(1024 // a["cg"] // 128):
        for p in range(4):
            banks = set()
            for lane in range(32):
                m = _pixel_slot(a, pwi, lane, p)
                slots.add(m)
                im, rem = divmod(m, per_img)
                cy, cx = divmod(rem, a["ccw"])
                banks.add((im * a["pimg"] + cy * a["prs"] + cx * a["cs"]) % 32)
            assert len(banks) == 32
    assert slots == set(range(1024 // a["cg"]))  # every pixel of the tile, once


def test_conv_args_match_the_kernel_struct():
    names = _conv_arg_names()
    plan = conv_plan((3, 17, 19, 3), (3, 3, 3, 33), (1, 1), "same", (2, 2))
    args = conv_args(plan, (3, 17, 19, 3), (3, 3, 3, 33), (1, 1), "relu")
    assert len(names) == len(args) == 38
    a = dict(zip(names, args))
    assert (a["cg"], a["ctiles"], a["cs"] % 2, a["ldt"] % 2) == (2, 2, 1, 1)
    assert a["patch_floats"] % 4 == 0 and a["stage_floats"] % 4 == 0


# -------------------------------------------------------------- network


@pytest.mark.parametrize("pallas", [False, True], ids=["lax", "pallas"])
def test_network_forward_matches_jax_and_the_oracle(conv_file, monkeypatch, pallas):
    monkeypatch.setattr(jax_network, "_PALLAS_CONV", pallas)
    jmodel = jax_schema.load_model(conv_file)
    jplan, jparams = jax_network.build_network(jmodel)
    x = np.random.default_rng(4).uniform(0, 1, (7, jmodel.input_dim)).astype(np.float32)
    want = np.asarray(jax_network.network_forward(jplan, jparams, jnp.asarray(x)))
    model = pt_schema.load_model(conv_file)
    plan, params = network.build_network(model, device="cpu")
    from_jax = network.network_params_from_jax(jparams, device="cpu")
    assert [sorted(p) for p in from_jax] == [sorted(p) for p in params]
    for a, b in zip(from_jax, params):
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    got = network.network_forward(plan, from_jax, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle.oracle_forward_batch(model, x), rtol=2e-4, atol=1e-5)
    logits = network.network_logits(plan, params, torch.from_numpy(x)).numpy()
    jlogits = np.asarray(jax_network.network_logits(jplan, jparams, jnp.asarray(x)))
    np.testing.assert_allclose(logits, jlogits, rtol=2e-5, atol=1e-5)


def test_network_edge_plans_match_jax():
    """A pool that follows no conv, a conv with no pool, a strided VALID
    conv, a dense layer before the convs, and a softmax conv."""
    rng = np.random.default_rng(5)
    layers = [
        jax_schema.LayerSpec(rng.normal(size=(12, 48)) * 0.3, rng.normal(size=48) * 0.1, "tanh"),
        jax_schema.MaxPool2DSpec(in_shape=(4, 4, 3), window=(2, 2), stride=(1, 1)),
        jax_schema.Conv2DSpec((3, 3, 3), rng.normal(size=(2, 2, 3, 5)) * 0.3,
                              rng.normal(size=5) * 0.1, (1, 1), "valid", "softmax"),
        jax_schema.Conv2DSpec((2, 2, 5), rng.normal(size=(1, 1, 5, 4)) * 0.3,
                              rng.normal(size=4) * 0.1, (2, 2), "valid", "gelu"),
        jax_schema.LayerSpec(rng.normal(size=(4, 3)) * 0.3, np.zeros(3), "softmax", "output"),
    ]
    jmodel = jax_schema.ModelSpec(layers)
    jmodel.validate_chain()
    model = pt_schema.ModelSpec.from_json_dict(jmodel.to_json_dict())
    x = rng.uniform(size=(6, 12)).astype(np.float32)
    jplan, jparams = jax_network.build_network(jmodel)
    want = np.asarray(jax_network.network_forward(jplan, jparams, jnp.asarray(x)))
    plan, params = network.build_network(model, device="cpu")
    assert [p.kind for p in plan] == [p.kind for p in jplan]
    got = network.network_forward(plan, params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle.oracle_forward_batch(model, x), rtol=2e-4, atol=1e-5)


def test_init_conv_mlp_and_export_match_jax_structure():
    gen = torch.Generator().manual_seed(0)
    model = network.init_conv_mlp(gen)
    jmodel = jax_network.init_conv_mlp(jax.random.key(0))
    assert [(l.kind, l.in_dim, l.out_dim, l.activation) for l in model.layers] == [
        (l.kind, l.in_dim, l.out_dim, l.activation) for l in jmodel.layers]
    n_params = sum(l.weights.size + l.biases.size for l in model.layers if l.kind != "maxpool2d")
    assert n_params == 136_874
    w = model.layers[2].weights  # 3x3x16x32, He-normal
    assert abs(float(w.std()) - (2.0 / 144) ** 0.5) < 0.01
    small = network.init_conv_mlp(torch.Generator().manual_seed(1), in_shape=(6, 6, 1),
                                  conv_filters=(3,), hidden=(), num_classes=2,
                                  pool_after_conv=False)
    assert [l.kind for l in small.layers] == ["conv2d", "dense"]
    plan, params = network.build_network(small, device="cpu")
    params[0]["w"] = params[0]["w"] + 1.0
    back = network.network_model_from_params(small, params)
    np.testing.assert_allclose(back.layers[0].weights, small.layers[0].weights + 1.0, atol=1e-6)
    assert back.layers[1].kind == "dense" and back is not small


# --------------------------------------------------------------- engine


def test_engine_matches_the_jax_engine(conv_file, caplog):
    jmodel = jax_schema.load_model(conv_file)
    x = np.random.default_rng(6).uniform(0, 1, (23, jmodel.input_dim))
    labels = np.random.default_rng(7).integers(0, 4, 23)
    want = JaxEngine.up(jmodel, [len(jmodel.layers)]).run_inference(x, labels, batch_size=8)
    reset_launch_counts()
    with caplog.at_level("INFO"):
        eng = Engine.up(conv_file, [2, 2, 2], device="cpu", warm_rows=3)
    assert "collapsing to the single-program executor" in caplog.text
    got = eng.run_inference(x, labels, batch_size=8)
    assert got.outputs.shape == (23, 4) and len(got.batch_seconds) == 3
    np.testing.assert_allclose(got.outputs, want.outputs, rtol=5e-4, atol=1e-5)
    assert got.metrics == want.metrics
    np.testing.assert_allclose(
        got.outputs, oracle.oracle_forward_batch(eng.model, x), rtol=5e-4, atol=1e-5)
    assert eng.placement()["distribution"] == [6] and eng.warm_bucket_count == 3
    out, seconds = eng.infer_single(x[0])
    np.testing.assert_array_equal(out, eng.infer(x[:1])[0])
    assert [fn.launches for fn in KERNEL_WRAPPERS] == [0] * len(KERNEL_WRAPPERS)


def test_engine_int8_export_and_down_on_a_conv_model(conv_file, tmp_path):
    jmodel = jax_schema.load_model(conv_file)
    with pytest.raises(ValueError, match="dense models only") as want:
        JaxEngine.up(jmodel, quantize="int8")
    with pytest.raises(InvalidArgumentError, match="dense models only") as got:
        Engine.up(conv_file, device="cpu", quantize="int8")
    assert str(got.value) == str(want.value)
    eng = Engine.up(conv_file, device="cpu")
    out = tmp_path / "exported.json"
    eng.export(out, metrics={"accuracy": 0.25})
    back = jax_schema.load_model(out)
    assert back.metadata["inference_metrics"] == {"accuracy": 0.25}
    assert back.to_json_dict()["layers"] == jmodel.to_json_dict()["layers"]
    with pytest.raises(InvalidArgumentError, match="Expected input dimension 192"):
        eng.infer(np.zeros((2, 191)))
    eng.down()
    assert not eng.is_ready


# ------------------------------------------------------------------ CLI


def _lines(text, prefix):
    return [l for l in text.splitlines() if l.startswith(prefix)]


def test_cli_infer_and_oracle_print_the_lines_tdn_prints(conv_file, tmp_path, capsys):
    x = np.random.default_rng(8).uniform(0, 1, (20, 192))
    ex = tmp_path / "ex.json"
    jax_schema.save_examples(x, np.random.default_rng(9).integers(0, 4, 20), ex)
    common = ["--config", str(conv_file), "--inputs", str(ex)]
    assert tdn_main(["infer", *common, "--batch-size", "8"]) == 0
    want = capsys.readouterr().out
    assert port_main(["infer", *common, "--batch-size", "8", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    for prefix in ("Correct predictions:", "Metrics:"):
        assert _lines(got, prefix) == _lines(want, prefix) and _lines(got, prefix)
    pattern = r"Total inference time: \d+\.\d{4} seconds \(\d+\.\d samples/sec\)"
    assert re.fullmatch(pattern, _lines(got, "Total")[0])

    assert tdn_main(["infer", "3", *common]) == 0
    want = capsys.readouterr().out
    assert port_main(["infer", "3", *common, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _lines(got, "Label:") == _lines(want, "Label:") and _lines(got, "Label:")
    g = json.loads(_lines(got, "Output:")[0][len("Output: "):])
    w = json.loads(_lines(want, "Output:")[0][len("Output: "):])
    np.testing.assert_allclose(g, w, rtol=5e-4, atol=1e-5)

    assert tdn_main(["oracle", *common]) == 0
    want = capsys.readouterr().out.splitlines()
    assert port_main(["oracle", *common]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 22
    for g, w in zip(got, want):
        assert re.sub(r"\d", "0", g) == re.sub(r"\d", "0", w)


_BLOCKED_CONV_RUN = r"""
import importlib.abc, sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn"):
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
import torch
from tpu_dist_nn_torch.api.engine import Engine
from tpu_dist_nn_torch.cli import main
from tpu_dist_nn_torch.core.schema import save_examples, save_model
from tpu_dist_nn_torch.kernels import fused_conv2d
from tpu_dist_nn_torch.models.network import init_conv_mlp
from tpu_dist_nn_torch.testing.oracle import oracle_forward_batch

model = init_conv_mlp(torch.Generator().manual_seed(0), in_shape=(8, 8, 3),
                      conv_filters=(4, 8), hidden=(16,), num_classes=4)
save_model(model, sys.argv[1] + "/conv.json")
x = np.random.default_rng(0).uniform(size=(10, 192))
out = Engine.up(sys.argv[1] + "/conv.json", [2, 2, 2], device="cpu").run_inference(
    x, batch_size=4).outputs
assert out.shape == (10, 4)
assert np.abs(out - oracle_forward_batch(model, x)).max() < 1e-5
assert fused_conv2d.launches == 0
save_examples(x, np.zeros(10, np.int32), sys.argv[1] + "/ex.json")
assert main(["infer", "--config", sys.argv[1] + "/conv.json", "--inputs",
             sys.argv[1] + "/ex.json", "--device", "cpu"]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_dist_nn")]
assert not bad, bad
print("conv model served without jax")
"""


def test_conv_path_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_CONV_RUN, str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "without jax" in proc.stdout
