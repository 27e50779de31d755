"""The SqueezeSegV3 SAC block's fused serving path (``ops/sac_fused.py``,
kernel K4 ``csrc/sac_fused.cu``).

K4 replaces no TPU kernel: the JAX SAC block is plain XLA, and
``tests/test_torch_families.py`` holds the port's SACBlock against it. Here
the fused path is held against the block's own modules:

- the folded, tap-major twin equals the eval forward up to the 3x3 conv in
  float64 (the fold and the permutation are exact algebra there), and the
  whole block in float32 within 1e-5 (what folding a BatchNorm rounds);
- the tap-major order leaves the product unchanged;
- training mode, or grad on, runs the unfused modules and launches nothing;
- the fold cache follows ``load_state_dict`` and in-place updates;
- the wrapper refuses a dtype, shape or layout the kernel does not take.

Small shapes (B=2, 8x64, c in {32, 256}). The tests marked ``cuda`` run K4
against its twin on a card and skip without one; run them there with
``python -m pytest tests/test_torch_sac.py -m cuda --noconftest`` (the
suite's conftest imports JAX, which the card's machine does not need).
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from coarse3d_tpu_torch.models import squeezesegv3 as sq
from coarse3d_tpu_torch.models.squeezesegv3 import SACBlock, unfold3x3
from coarse3d_tpu_torch.ops import sac_fused as k4

B, H, W = 2, 8, 64


def _block(c: int, seed: int, dtype=torch.float64) -> SACBlock:
    """An eval SACBlock with random weights and BatchNorm statistics."""
    g = torch.Generator().manual_seed(seed)
    blk = SACBlock(c)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        for m in blk.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=g))
                m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                    + 0.5)
    return blk.to(dtype).eval()


def _inputs(c: int, seed: int, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn(B, 3, H, W, generator=g).to(dtype)
    feat = torch.randn(B, c, H, W, generator=g).relu().to(dtype)
    return xyz, feat


def _modules_mix(blk: SACBlock, xyz, feat):
    """The unfused expression up to the 3x3 conv."""
    new = unfold3x3(feat) * blk.attention_x(xyz).to(feat.dtype)
    return blk.position_mlp_2[:3](new)


@pytest.mark.parametrize("c", [32, 256])
def test_folded_twin_equals_the_eval_block_in_float64(c):
    blk = _block(c, seed=c)
    xyz, feat = _inputs(c, seed=1)
    with torch.no_grad():
        want = _modules_mix(blk, xyz, feat)
        got = k4.sac_fused(xyz, feat, blk.folded(torch.float64))
        whole = blk(xyz, feat)
        whole_want = blk.position_mlp_2(unfold3x3(feat)
                                        * blk.attention_x(xyz)) + feat
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(whole, whole_want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("c", [32, 256])
def test_fused_block_matches_modules_in_float32(c):
    blk = _block(c, seed=c + 1, dtype=torch.float32)
    xyz, feat = _inputs(c, seed=2, dtype=torch.float32)
    with torch.no_grad():
        got = blk(xyz, feat)
        want = blk.position_mlp_2(unfold3x3(feat)
                                  * blk.attention_x(xyz)) + feat
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("c", [32, 256])
def test_tap_major_order_leaves_the_product_unchanged(c):
    blk = _block(c, seed=c + 2)
    xyz, feat = _inputs(c, seed=3)
    w1, b1 = k4._fold_bn(blk.attention_x[0].weight, blk.attention_x[0].bias,
                         blk.attention_x[1], torch.float64)
    w2, b2 = k4._fold_bn(blk.position_mlp_2[0].weight,
                         blk.position_mlp_2[0].bias, blk.position_mlp_2[1],
                         torch.float64)
    with torch.no_grad():
        # channel-major: the unfold's own order, no permutation
        att = torch.sigmoid(w1 @ F.unfold(xyz, 7, padding=3) + b1[:, None])
        mix = w2 @ (att * F.unfold(feat, 3, padding=1)) + b2[:, None]
        want = torch.relu(mix).view(B, c, H, W)
        perm = k4.tap_major(c)
        assert sorted(perm.tolist()) == list(range(9 * c))
        packed = k4.pack_steps(w1[perm], b1[perm], w2[:, perm], b2,
                               torch.float64)
        got = k4.sac_fused_reference(xyz, feat, packed)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for a, b_ in zip(k4.unpack_steps(packed),
                     (w1[perm], b1[perm], w2[:, perm], b2)):
        assert torch.equal(a, b_)


def test_bf16_twin_rounds_the_product_as_the_kernel():
    blk = _block(32, seed=7, dtype=torch.float32)
    xyz, feat = _inputs(32, seed=4, dtype=torch.float32)
    xb, fb = xyz.to(torch.bfloat16), feat.to(torch.bfloat16)
    with torch.no_grad():
        got = k4.sac_fused(xb, fb, blk.folded(torch.bfloat16))
        want = _modules_mix(blk, xyz, feat)
    assert got.dtype == torch.bfloat16
    scale = float(want.abs().max())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=3e-2 * scale)


def _refuse_fused(*args, **kwargs):
    raise AssertionError("the fused path ran")


@pytest.mark.parametrize("mode", ["train", "eval_grad"])
def test_training_or_grad_runs_the_unfused_modules(mode, monkeypatch):
    monkeypatch.setattr(sq, "sac_fused", _refuse_fused)
    blk = _block(32, seed=9, dtype=torch.float32)
    xyz, feat = _inputs(32, seed=5, dtype=torch.float32)
    if mode == "train":
        blk.train()
    launches = k4.sac_fused.launches
    out = blk(xyz, feat)
    assert out.requires_grad
    out.sum().backward()
    assert blk.attention_x[0].weight.grad is not None
    assert k4.sac_fused.launches == launches
    with torch.no_grad():
        if mode == "train":
            blk.eval()
        with pytest.raises(AssertionError, match="fused path ran"):
            blk(xyz, feat)


def test_fold_cache_follows_load_state_dict_and_in_place_updates():
    blk = _block(32, seed=11, dtype=torch.float32)
    other = _block(32, seed=12, dtype=torch.float32)
    xyz, feat = _inputs(32, seed=6, dtype=torch.float32)
    with torch.no_grad():
        first = blk(xyz, feat)
        assert torch.equal(blk(xyz, feat), first)       # cached, same
        folded = blk.folded(torch.float32)
        assert blk.folded(torch.float32) is folded
        blk.load_state_dict(other.state_dict())
        loaded = blk(xyz, feat)
        torch.testing.assert_close(loaded, other(xyz, feat), rtol=0,
                                   atol=0)
        assert not torch.allclose(loaded, first)
        blk.position_mlp_2[1].running_var.mul_(4.0)     # an in-place change
        assert not torch.allclose(blk(xyz, feat), loaded)
        want = blk.position_mlp_2(unfold3x3(feat)
                                  * blk.attention_x(xyz)) + feat
        torch.testing.assert_close(blk(xyz, feat), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def _bad_cases():
    xyz, feat = _inputs(32, seed=8, dtype=torch.float32)
    w = _block(32, seed=13, dtype=torch.float32).folded(torch.float32)
    w64 = _block(64, seed=14, dtype=torch.float32).folded(torch.float32)
    nc = feat.transpose(2, 3).contiguous().transpose(2, 3)
    return {
        "xyz_dtype": (xyz.double(), feat, w, TypeError),
        "int_dtype": (xyz.int(), feat.int(), w, TypeError),
        "weights_dtype": (xyz, feat, w._replace(steps=w.steps.double()),
                          TypeError),
        "xyz_shape": (xyz[:, :2], feat, w, ValueError),
        "feature_3d": (xyz, feat[0], w, ValueError),
        "width_24": (xyz, feat[:, :24].contiguous(), w, ValueError),
        "weights_width": (xyz, feat, w64, ValueError),
        "non_contiguous": (xyz, nc, w, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_wrapper_refuses_bad_inputs(case):
    xyz, feat, w, err = _bad_cases()[case]
    with pytest.raises(err):
        k4.sac_fused(xyz, feat, w)


def test_pack_steps_refuses_a_width_outside_the_kernel():
    with pytest.raises(ValueError):
        k4.pack_steps(torch.zeros(9 * 48, 147), torch.zeros(9 * 48),
                      torch.zeros(48, 9 * 48), torch.zeros(48),
                      torch.float32)


# -- on a card -------------------------------------------------------------

# SqueezeSegV3-21's five SAC stage shapes on the 64x2048 image (c, W), and a
# width the 128-pixel row segment does not divide
CARD_SHAPES = [(32, 2048), (64, 1024), (128, 512), (256, 256), (64, 200)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("K4 is a CUDA kernel: needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c,w", CARD_SHAPES)
def test_kernel_matches_twin_on_the_card(card, c, w):
    """bf16 at B=8: the kernel and the twin sum the same bf16 operands in
    float32, in another order, and the kernel's sigmoid is __expf's, so the
    product that both round to bf16 can land an ulp apart; each output is
    then within one bf16 ulp (2^-7 relative) of the twin's plus 1e-3 of the
    largest output (a few flipped product roundings)."""
    g = torch.Generator(device=card).manual_seed(c + w)
    blk = _block(c, seed=c, dtype=torch.float32).to(card)
    xyz = torch.randn(8, 3, 64, w, generator=g, device=card).to(
        torch.bfloat16)
    feat = torch.randn(8, c, 64, w, generator=g, device=card).relu().to(
        torch.bfloat16)
    with torch.inference_mode():
        weights = blk.folded(torch.bfloat16)
        launches = k4.sac_fused.launches
        got = k4.sac_fused(xyz, feat, weights).float()
        want = k4.sac_fused_reference(xyz, feat, weights).float()
    torch.cuda.synchronize()
    assert k4.sac_fused.launches == launches + 1
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-3 * scale)
